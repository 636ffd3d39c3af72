"""Progressive distillation of the sampler into a few-step student (port
of agdiff_tpu/train/distill.py; Salimans & Ho, "Progressive Distillation
for Fast Sampling of Diffusion Models", ICLR 2022).

A student, initialised as a copy of its teacher, learns to make ONE
deterministic DDIM step that lands where TWO consecutive teacher steps
land, halving the ladder per stage (64 -> 32 -> 16 -> 8 steps). The
student is sampled with the generation CLI on the grid it was trained
for:

    python -m agdiff_torch.cli.generate <stage_dir> --fast \\
        --sampling_type generalized --eta 0 --ladder strided \\
        --n_steps <stage steps>

Per step of the loss:

  * each graph draws a student step k, so one batch trains every level
    of the ladder: (start, mid, next) = ladder_triplets(...)[k], their
    sigmas per graph, -1 meaning sigma 0;
  * pos_i = pos + noise * sigma_i, the noise zero on padded nodes;
  * the teacher (eval mode, no gradient) makes two DDIM steps at eta 0,
    pos_i -> pos_m -> pos_j, each on the drift that sampling assembles
    (sampling/langevin.py::assemble_drift with a (B,) sigma: the local
    branch and its clip_local, the global branch gated by
    global_start_sigma and weighted w_global);
  * the target is eps = (pos_j - pos_i) / (sigma_j - sigma_i) (a
    difference below 1e-12 divides by 1), and the student's eps is minus
    its drift at (pos_i, sigma_i);
  * the loss is the weighted squared error summed over real nodes, over
    max(their count, 1). The module runs with train=False, so the
    student's running statistics stay as the teacher's were.

With a data-parallel `group` (parallel/data_parallel.py
make_parallel_distill_step) the step follows the train step's rules:
k and the noise drawn at the global batch's shape and sliced, the loss
over the global real-node count, the gradients summed over the ranks.
The teacher's rollout is per-graph and needs no collective.

Positions are not re-centred inside the rollout, as in the JAX package.
The ladder grid is numpy's round(linspace(T - 1, 0, n)), JAX's
`strided_ladder`; the sampler's strided grid is XLA's float32 linspace
(sampling/langevin.py::ladder_indices), which differs from it for a few
(T, n) (T = 5000, n = 143 and 285): the loss keeps JAX's grid.
"""

from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from agdiff_torch.config import Config
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.sampling.langevin import SamplerConfig, assemble_drift
from agdiff_torch.train.optimizer import make_optimizer
from agdiff_torch.train.train_step import (
    TrainState,
    ema_copy,
    global_draw_rows,
    update_ema,
)

WEIGHTINGS = ("trunc-snr", "eps", "step")


class DistillMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor


def strided_ladder(num_timesteps: int, n_steps: int) -> np.ndarray:
    """The student's grid: round(linspace(T - 1, 0, n)) in numpy's
    float64, half to even (agdiff_tpu/train/distill.py:65-70)."""
    return np.round(np.linspace(num_timesteps - 1, 0, n_steps)
                    ).astype(np.int32)


def ladder_triplets(num_timesteps: int, n_student: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(start, mid, next) timestep indices of every student step: start
    -> next is one student step, start -> mid -> next the two teacher
    steps. next is -1 (sigma 0) after the last level; mid is the floor of
    the mean, so the last step's mid is -1 too and its second teacher
    step does nothing."""
    idx = strided_ladder(num_timesteps, n_student).astype(np.int64)
    nxt = np.concatenate([idx[1:], [-1]])
    mid = (idx + nxt) // 2
    return idx.astype(np.int32), mid.astype(np.int32), nxt.astype(np.int32)


def student_from(teacher: torch.nn.Module) -> torch.nn.Module:
    """A copy of the teacher's parameters and buffers (no shared tensor),
    trainable."""
    student = copy.deepcopy(teacher)
    student.requires_grad_(True)
    return student


def create_distill_state(config: Config, teacher: torch.nn.Module, device,
                         seed: int) -> TrainState:
    """The student (a copy of the teacher) on `device`, its two Adams
    (config.train's), the step generator on the device seeded with `seed`
    and, when config.train.ema_decay > 0, the EMA shadow."""
    device = torch.device(device)
    module = student_from(teacher).to(device)
    return TrainState(
        step=0, module=module,
        optimizer=make_optimizer(module, config.train),
        generator=torch.Generator(device=device).manual_seed(seed),
        ema=ema_copy(module) if config.train.ema_decay > 0 else None)


class DistillLoss:
    """loss(student, teacher, batch, k, noise) -> scalar (the module
    docstring). `weighting` is the per-graph weight of the squared error:
    'trunc-snr' max(1, sigma_i^2), 'eps' 1, 'step' (sigma_j -
    sigma_i)^2."""

    def __init__(self, config: Config, sampler_config: SamplerConfig,
                 n_student: int, device, weighting: str = "trunc-snr",
                 group=None):
        if weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {weighting!r}")
        self.weighting = weighting
        self.group = group
        self.sampler_config = sampler_config
        self.n_student = n_student
        diffusion = make_diffusion(config.model)
        self.sigmas = torch.as_tensor(diffusion.sigmas, dtype=torch.float32,
                                      device=device)
        self.start, self.mid, self.next = (
            torch.as_tensor(a, dtype=torch.int64, device=device)
            for a in ladder_triplets(diffusion.num_timesteps, n_student))

    def draws(self, generator: torch.Generator, batch: GraphBatch, k=None,
              noise=None):
        """(k (B,), noise (B, N, 3)): each drawn from `generator` unless
        given (tests inject JAX's); with a group, the global batch's,
        sliced to this rank's rows."""
        b, rows = global_draw_rows(batch, self.group)
        dev = batch.pos.device
        if k is None:
            k = torch.randint(0, self.n_student, (b,), generator=generator,
                              device=dev)
        if noise is None:
            noise = torch.randn((b,) + tuple(batch.pos.shape[1:]),
                                generator=generator, device=dev,
                                dtype=batch.pos.dtype)
        return k[rows].to(dev), noise[rows].to(dev)

    def sigma_of(self, idx):
        """sigma at each timestep index, 0 at -1."""
        return torch.where(idx >= 0, self.sigmas[idx.clamp(min=0)],
                           torch.zeros((), device=idx.device))

    def drift(self, module, batch: GraphBatch, pos, sigma):
        cfg = self.sampler_config
        out = module(batch.replace(pos=pos), train=False,
                     extend_order=cfg.extend_order,
                     extend_radius=cfg.extend_radius)
        return assemble_drift(out, pos, sigma, cfg)

    def __call__(self, student, teacher, batch: GraphBatch, k, noise):
        s_i = self.sigma_of(self.start[k])
        s_m = self.sigma_of(self.mid[k])
        s_j = self.sigma_of(self.next[k])
        noise = noise * batch.node_mask[..., None]
        pos_i = batch.pos + noise * s_i[:, None, None]
        with torch.no_grad():
            eps1 = -self.drift(teacher, batch, pos_i, s_i)
            pos_m = pos_i + (s_m - s_i)[:, None, None] * eps1
            eps2 = -self.drift(teacher, batch, pos_m, s_m)
            pos_j = pos_m + (s_j - s_m)[:, None, None] * eps2
            c = s_j - s_i
            c = torch.where(c.abs() < 1e-12, torch.ones_like(c), c)
            target = (pos_j - pos_i) / c[:, None, None]
        eps_s = -self.drift(student, batch, pos_i, s_i)
        w_node = (batch.node_mask & batch.graph_mask[:, None]).float()
        sq = torch.sum((eps_s - target) ** 2, dim=-1)
        if self.weighting == "trunc-snr":
            w = torch.clamp(s_i * s_i, min=1.0)[:, None]
        elif self.weighting == "step":
            w = torch.square(s_j - s_i)[:, None]
        else:
            w = torch.ones_like(s_i)[:, None]
        count = torch.sum(w_node)
        if self.group is not None:
            count = self.group.all_reduce(count)
        return torch.sum(sq * w * w_node) / torch.clamp(count, min=1.0)


class DistillStep:
    """(state, teacher, batch[, k, noise]) -> DistillMetrics, updating the
    state in place: the loss, its gradients, their global norm before
    the clip, the clip and the two Adams of config.train, then the EMA
    when config.train.ema_decay > 0 (agdiff_tpu/train/distill.py:
    160-201)."""

    def __init__(self, config: Config, sampler_config: SamplerConfig,
                 n_student: int, device, weighting: str = "trunc-snr",
                 group=None):
        self.loss = DistillLoss(config, sampler_config, n_student, device,
                                weighting, group)
        self.ema_decay = config.train.ema_decay
        self.group = group

    def __call__(self, state: TrainState, teacher, batch: GraphBatch,
                 k=None, noise=None) -> DistillMetrics:
        k, noise = self.loss.draws(state.generator, batch, k, noise)
        loss = self.loss(state.module, teacher, batch, k, noise)
        state.optimizer.zero_grad()
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            self.group.sum_gradients(state.optimizer.params)
            loss = self.group.all_reduce(loss)
        grad_norm = state.optimizer.step()
        update_ema(state, self.ema_decay)
        state.step += 1
        return DistillMetrics(loss, grad_norm)


def make_distill_step(config: Config, sampler_config: SamplerConfig,
                      n_student: int, device,
                      weighting: str = "trunc-snr") -> DistillStep:
    return DistillStep(config, sampler_config, n_student, device, weighting)


def make_chunked_distill_step(config: Config, sampler_config: SamplerConfig,
                              n_student: int, device,
                              weighting: str = "trunc-snr"):
    """(state, teacher, batches[, ks, noises]) -> the last step's
    metrics: K = len(batches) single steps in a row (JAX scans them in one
    program; here that is all the chunk means)."""
    step = make_distill_step(config, sampler_config, n_student, device,
                             weighting)

    def chunked(state: TrainState, teacher, batches: List[GraphBatch],
                ks=None, noises=None) -> DistillMetrics:
        for i, batch in enumerate(batches):
            metrics = step(state, teacher, batch,
                           None if ks is None else ks[i],
                           None if noises is None else noises[i])
        return metrics

    return chunked


class DistillEvalStep:
    """Validation: the distill loss times the real-node count, and the
    count (agdiff_tpu/train/distill.py:236-252)."""

    def __init__(self, config: Config, sampler_config: SamplerConfig,
                 n_student: int, device, weighting: str = "trunc-snr"):
        self.loss = DistillLoss(config, sampler_config, n_student, device,
                                weighting)

    @torch.no_grad()
    def __call__(self, state: TrainState, teacher, batch: GraphBatch,
                 generator: Optional[torch.Generator] = None, k=None,
                 noise=None) -> Dict[str, torch.Tensor]:
        k, noise = self.loss.draws(generator, batch, k, noise)
        loss = self.loss(state.module, teacher, batch, k, noise)
        count = torch.sum((batch.node_mask
                           & batch.graph_mask[:, None]).float())
        return {"sum_loss": loss * count, "count": count}


def make_distill_eval_step(config: Config, sampler_config: SamplerConfig,
                           n_student: int, device,
                           weighting: str = "trunc-snr") -> DistillEvalStep:
    return DistillEvalStep(config, sampler_config, n_student, device,
                           weighting)
