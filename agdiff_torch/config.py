"""Configuration (port of agdiff_tpu/config.py).

Configs are frozen dataclasses read from the same YAML files as the JAX
package (configs/*.yml); unknown keys are ignored there too. One
difference of form: `Config.buckets` is the tuple of bucket sizes itself
(the generation side reads it so), where the JAX package wraps it in a
BucketConfig; the JSON and YAML writers emit the JAX form,
`buckets: {max_nodes: [...]}`, so a file written by either package loads
in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import yaml


@dataclass(frozen=True)
class ModelConfig:
    """Score-network hyperparameters (reference: configs/qm9_default.yml)."""

    type: str = "diffusion"
    network: str = "dualenc"
    hidden_dim: int = 128
    num_convs: int = 6            # global (SchNet) interaction blocks
    num_convs_local: int = 4      # local (GIN) convolutions
    cutoff: float = 10.0          # radius-graph cutoff (Angstrom)
    mlp_act: str = "relu"
    beta_schedule: str = "sigmoid"
    beta_start: float = 1.0e-7
    beta_end: float = 2.0e-3
    num_diffusion_timesteps: int = 5000
    edge_order: int = 3           # bond-graph order extension
    edge_encoder: str = "mlp"
    smooth_conv: bool = False     # cosine (True) vs Gaussian (False) envelope
    sigma_begin: float = 10.0     # the legacy 'dsm' branch's schedule
    sigma_end: float = 0.01
    num_noise_level: int = 50
    tie_edge_encoders: bool = True
    edge_attention_mode: str = "softmax_dim1"
    embedding_max_norm: Optional[float] = 10.0
    dtype: str = "float32"        # engine compute dtype: float32 | bfloat16
    # training: recompute the encoders in backward instead of keeping their
    # activations (torch.utils.checkpoint)
    remat: bool = False
    # per-edge tensors on the N(N-1)/2 unordered pairs instead of the N^2
    # block (every per-edge quantity is symmetric; BatchNorm is node-space)
    packed_pairs: bool = False

    @property
    def num_timesteps(self) -> int:
        if self.type == "diffusion":
            return self.num_diffusion_timesteps
        return self.num_noise_level


@dataclass(frozen=True)
class OptimizerConfig:
    type: str = "adam"
    lr: float = 1.0e-3
    weight_decay: float = 0.0
    beta1: float = 0.95
    beta2: float = 0.999


@dataclass(frozen=True)
class SchedulerConfig:
    type: str = "plateau"  # 'plateau' | 'expmin' | 'expmin_milestone'
    factor: float = 0.6
    patience: int = 10
    min_lr: float = 0.0
    milestone: int = 1     # expmin_milestone: gamma = factor^(1/milestone)


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 2021
    batch_size: int = 64
    val_freq: int = 5000
    max_iters: int = 1_000_000
    max_grad_norm: float = 10000.0
    anneal_power: float = 2.0     # accepted and unused, as in the reference
    skip_nonfinite_updates: bool = False
    step_chunk: int = 1           # steps per loader group (eager here)
    ema_decay: float = 0.0        # 0: no EMA shadow
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


@dataclass(frozen=True)
class DatasetConfig:
    train: Optional[str] = None
    val: Optional[str] = None
    test: Optional[str] = None


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    buckets: Tuple[int, ...] = (32, 64)


_NESTED = {"model": ModelConfig, "train": TrainConfig,
           "optimizer": OptimizerConfig, "scheduler": SchedulerConfig,
           "dataset": DatasetConfig}


def _build(cls, data: Optional[Dict[str, Any]]):
    """A dataclass from a nested dict, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in names:
            continue
        if key == "buckets" and cls is Config:
            value = (value or {}).get("max_nodes", (32, 64)) \
                if isinstance(value, dict) else value
            kwargs[key] = tuple(int(b) for b in value)
        elif key in _NESTED and isinstance(value, dict):
            kwargs[key] = _build(_NESTED[key], value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def model_config_from_dict(raw: Dict[str, Any]) -> ModelConfig:
    return _build(ModelConfig, raw)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    return _build(Config, raw)


def load_config(path: str) -> Config:
    """Read a YAML config (the JAX package's files load unchanged)."""
    with open(path) as f:
        return config_from_dict(yaml.safe_load(f) or {})


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    """The JAX package's layout (`buckets: {max_nodes: [...]}`)."""
    out = dataclasses.asdict(cfg)
    out["buckets"] = {"max_nodes": list(cfg.buckets)}
    return out


def config_to_json(cfg: Config) -> str:
    return json.dumps(config_to_dict(cfg))


def config_from_json(s: str) -> Config:
    return config_from_dict(json.loads(s))


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f)
