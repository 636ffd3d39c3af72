"""Optimizers and learning-rate schedules (port of
agdiff_tpu/train/optimizer.py:29-166).

The reference trains two independent Adams over disjoint parameter sets,
the global branch and the local one (scripts/train.py:96-100), after ONE
gradient-norm clip over all parameters (train.py:136), with a
ReduceLROnPlateau schedule per Adam driven by the validation losses. The
JAX package builds that from optax; this is the same arithmetic in
PyTorch, with optax's formulas and order:

  1. skip_nonfinite_updates: optax.apply_if_finite(max_consecutive_errors=
     100) - a step whose gradients hold a non-finite value changes neither
     the parameters nor either Adam's moments or count;
  2. clip_by_global_norm: g -> (g / |g|) * max_norm when |g| >= max_norm
     (not torch's clip_grad_norm_, which divides by |g| + 1e-6);
  3. per partition, add_decayed_weights (g + wd * p: coupled L2, not
     AdamW) when weight_decay, then optax.adam: eps 1e-8 outside the
     root, bias-corrected moments, p += -lr * m^ / (sqrt(v^) + eps).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agdiff_torch.config import OptimizerConfig, SchedulerConfig, TrainConfig

GLOBAL = "global"
LOCAL = "local"
MAX_CONSECUTIVE_ERRORS = 100

# everything else, the tied edge encoder included, is global (the
# reference quirk: dualenc.py:214 encodes the local branch with the global
# encoder)
_LOCAL_PREFIXES = ("edge_encoder_local", "encoder_local",
                   "grad_local_dist_mlp")


def param_partition(module: nn.Module) -> Dict[str, str]:
    """Each parameter name's label, 'global' or 'local', by its top-level
    module name."""
    return {name: (LOCAL if name.split(".")[0].startswith(_LOCAL_PREFIXES)
                   else GLOBAL)
            for name, _ in module.named_parameters()}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of every element together (optax.global_norm), as the
    norm of the per-tensor norms (two launches)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _f32(x: float) -> float:
    return float(np.float32(x))


class Adam:
    """optax.adam (with add_decayed_weights before it when weight_decay)
    over one list of parameters; its state is count, mu and nu. The JAX
    package injects the hyperparameters (optax.inject_hyperparams), which
    makes them float32 arrays, so 1 - b1, 1 - b2 and the bias corrections
    are float32 arithmetic (1 - b2 is 0.00099998713, not 0.001)."""

    def __init__(self, params: List[torch.Tensor], opt: OptimizerConfig,
                 lr: float, eps: float = 1e-8):
        self.params = params
        self.b1, self.b2, self.eps = _f32(opt.beta1), _f32(opt.beta2), \
            _f32(eps)
        one = np.float32(1.0)
        self.c1 = float(one - np.float32(opt.beta1))
        self.c2 = float(one - np.float32(opt.beta2))
        self.weight_decay = opt.weight_decay
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        if not self.params:
            return
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=self.c1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads),
                            alpha=self.c2)
        one, c = np.float32(1.0), np.float32(self.count)
        bc1 = float(one - np.float32(self.b1) ** c)
        bc2 = float(one - np.float32(self.b2) ** c)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(upd, -_f32(self.lr))
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "lr": self.lr, "mu": self.mu,
                "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count, self.lr = int(state["count"]), float(state["lr"])
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)


class TwoAdams:
    """The reference's optimizer: one shared clip, then one Adam per
    partition (param_partition). `step()` reads each parameter's .grad
    and returns the gradients' global norm before the clip (a tensor on
    the parameters' device)."""

    def __init__(self, module: nn.Module, train_cfg: TrainConfig):
        opt = train_cfg.optimizer
        if opt.type != "adam":
            raise NotImplementedError(opt.type)
        labels = param_partition(module)
        named = list(module.named_parameters())
        self.params = [p for _, p in named]
        self.labels = [labels[n] for n, _ in named]
        self.adams = {k: Adam([p for p, lab in zip(self.params, self.labels)
                               if lab == k], opt, opt.lr)
                      for k in (GLOBAL, LOCAL)}
        self.max_grad_norm = float(train_cfg.max_grad_norm)
        self.skip_nonfinite = bool(train_cfg.skip_nonfinite_updates)
        self.notfinite_count = 0
        # a sharded state's (use_shards): which parameters are one rank's
        # slice, and the model axis the slices span
        self.sharded: Optional[List[bool]] = None
        self.shard_group = None

    def use_shards(self, shards: Dict[int, tuple], group) -> None:
        """Take shards in place of parameters (parallel/sharded.py):
        `shards` maps id(parameter) to (its shard, cut), cut(t) this
        rank's slice of a tensor of the parameter's shape, which also
        cuts the parameter's Adam moments. The clip's global norm and the
        finite check then span `group`'s ranks, each shard counted on its
        rank and a whole parameter once."""
        for adam in self.adams.values():
            for j, p in enumerate(adam.params):
                if id(p) in shards:
                    shard, cut = shards[id(p)]
                    adam.params[j] = shard
                    adam.mu[j] = cut(adam.mu[j]).clone()
                    adam.nu[j] = cut(adam.nu[j]).clone()
        self.sharded = [id(p) in shards for p in self.params]
        self.params = [shards[id(p)][0] if id(p) in shards else p
                       for p in self.params]
        self.shard_group = group

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients: of every rank's shards and
        the whole parameters once, on a sharded state."""
        if self.shard_group is None:
            return global_norm(grads)
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        mask = torch.tensor(self.sharded, device=sq.device)
        shards = self.shard_group.all_reduce(sq[mask].sum().reshape(1))
        return torch.sqrt(shards[0] + sq[~mask].sum())

    def finite(self, grads: List[torch.Tensor]) -> bool:
        """Every gradient finite, on every rank of a sharded state."""
        bad = (~torch.stack([torch.isfinite(g).all() for g in grads])).sum()
        if self.shard_group is not None:
            bad = self.shard_group.all_reduce(bad.float().reshape(1))
        return not bool(bad.sum())

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        norm = self.norm(grads)
        if self.skip_nonfinite:
            finite = self.finite(grads)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return norm
        trigger = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        clipped = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(trigger, one, norm)),
            torch.where(trigger, one, torch.full_like(norm,
                                                      self.max_grad_norm)))
        for k, adam in self.adams.items():
            adam.update([g for g, lab in zip(clipped, self.labels)
                         if lab == k])
        return norm

    def set_learning_rates(self, lr_global: float, lr_local: float) -> None:
        self.adams[GLOBAL].lr = float(lr_global)
        self.adams[LOCAL].lr = float(lr_local)

    def get_learning_rates(self) -> Tuple[float, float]:
        return self.adams[GLOBAL].lr, self.adams[LOCAL].lr

    def state_dict(self) -> dict:
        return {"adams": {k: a.state_dict() for k, a in self.adams.items()},
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: dict) -> None:
        for k, a in self.adams.items():
            a.load_state_dict(state["adams"][k])
        self.notfinite_count = int(state["notfinite_count"])


def make_optimizer(module: nn.Module, train_cfg: TrainConfig) -> TwoAdams:
    return TwoAdams(module, train_cfg)


# --- host-side ReduceLROnPlateau (torch semantics: mode 'min', relative
# threshold 1e-4, lr * factor after `patience` observations without
# improvement; reference utils/common.py:75-81) ---


@dataclass(frozen=True)
class PlateauState:
    lr: float
    best: float = float("inf")
    num_bad: int = 0


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=lr)


def plateau_update(state: PlateauState, metric: float,
                   sched: SchedulerConfig,
                   threshold: float = 1e-4) -> PlateauState:
    if metric < state.best * (1.0 - threshold):
        return replace(state, best=metric, num_bad=0)
    num_bad = state.num_bad + 1
    if num_bad > sched.patience:
        return PlateauState(lr=max(state.lr * sched.factor, sched.min_lr),
                            best=state.best, num_bad=0)
    return replace(state, num_bad=num_bad)


def scheduler_step(state: PlateauState, metric: float,
                   sched: SchedulerConfig) -> PlateauState:
    """One step per validation (train.py:189-194): 'plateau' on the
    metric; 'expmin' lr = max(lr * factor, min_lr); 'expmin_milestone' the
    same with factor^(1 / milestone)."""
    if sched.type == "plateau":
        return plateau_update(state, metric, sched)
    if sched.type == "expmin":
        return replace(state, lr=max(state.lr * sched.factor, sched.min_lr))
    if sched.type == "expmin_milestone":
        gamma = math.exp(math.log(sched.factor) / max(sched.milestone, 1))
        return replace(state, lr=max(state.lr * gamma, sched.min_lr))
    raise NotImplementedError(f"Scheduler not supported: {sched.type}")
