"""Checkpoints (port of agdiff_tpu/train/checkpoint.py:26-131).

The JAX package's layout: <log_dir>/checkpoints/<iteration>/ holds the
state and a meta.json (the config as JSON, the iteration, avg_val_loss and
both plateau states), and <log_dir>/best_model/POINTER names the best
checkpoint's directory. The state is one `torch.save` file, state.pt: the
module's parameters and running statistics, both Adams' states, the step,
the step generator's state, the loader's draw state and, when the run
keeps one, the EMA shadow.

A checkpoint of the JAX package holds an orbax state/ directory, which
needs jax to read. The repository's convert_jax_checkpoint.py, run where
jax is installed, adds a state.npz beside it (its layout is in that
script's docstring); `load_checkpoint` reads a directory that has one
without jax, into the same payload as a port checkpoint's, and raises on
a directory with state/ alone, naming the converter. The JAX package
saves no generator or loader state, so the payload of a converted
checkpoint has neither (train/trainer.py `resume`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from agdiff_torch.config import Config, config_from_json, config_to_json
from agdiff_torch.train.optimizer import GLOBAL, LOCAL, PlateauState

STATE_FILE = "state.pt"
JAX_STATE_FILE = "state.npz"
UNCONVERTED = (
    "{path} is a checkpoint of the JAX package (an orbax state directory), "
    "which needs jax to read. Convert it first, on a machine with jax: "
    "python convert_jax_checkpoint.py {path} (from the repository's root; "
    "a log dir and --all convert every checkpoint of a run)")


def _ckpt_dir(log_dir: str) -> str:
    return os.path.join(os.path.abspath(log_dir), "checkpoints")


def save_checkpoint(log_dir: str, iteration: int, config: Config,
                    payload: Dict[str, Any], plateau_global: PlateauState,
                    plateau_local: PlateauState, avg_val_loss: float,
                    best: bool = False) -> str:
    """Write checkpoints/<iteration>/{state.pt, meta.json} (the state file
    through a temporary name, so a reader never sees half of one) and,
    when best, point best_model/POINTER at it."""
    path = os.path.join(_ckpt_dir(log_dir), str(iteration))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    meta = {"config": config_to_json(config), "iteration": iteration,
            "avg_val_loss": float(avg_val_loss),
            "plateau_global": dataclasses.asdict(plateau_global),
            "plateau_local": dataclasses.asdict(plateau_local)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if best:
        best_dir = os.path.join(os.path.abspath(log_dir), "best_model")
        os.makedirs(best_dir, exist_ok=True)
        with open(os.path.join(best_dir, "POINTER"), "w") as f:
            f.write(path)
    return path


def latest_checkpoint(log_dir: str, it: Optional[int] = None
                      ) -> Tuple[str, int]:
    """The checkpoint directory of iteration `it`, or of the latest."""
    d = _ckpt_dir(log_dir)
    iters = sorted(int(n) for n in os.listdir(d) if n.isdigit())
    if not iters:
        raise FileNotFoundError(f"no checkpoints in {d}")
    chosen = iters[-1] if it is None else it
    if chosen not in iters:
        raise FileNotFoundError(f"iteration {chosen} not found in {d}")
    return os.path.join(d, str(chosen)), chosen


def unconverted(path: str) -> bool:
    """A checkpoint directory of the JAX package that holds its orbax
    state/ alone, without the converter's state.npz."""
    return os.path.isdir(os.path.join(path, "state")) and not os.path.isfile(
        os.path.join(path, JAX_STATE_FILE))


def _unflatten(arrays: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """The nested dict of the npz's keys under `prefix/`."""
    tree: Dict[str, Any] = {}
    for key, value in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        *scope, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for k in scope:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def _torch_leaf(arrays, key: str, path: tuple) -> torch.Tensor:
    """The npz's array at `key` in the port's layout (a flax kernel (in,
    out) becomes a torch weight (out, in))."""
    arr = arrays[key]
    if path[-1] == "kernel":
        arr = arr.T
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def load_converted(path: str, config: Config) -> Dict[str, Any]:
    """The state.npz of a converted JAX checkpoint -> the entries of a port
    state file: the module's state_dict (models/weights.py
    load_jax_variables), each Adam's count, lr, mu and nu in TwoAdams'
    order (its partition's parameters in module order, each mapped to its
    flax leaf), notfinite_count, step and, when the run kept one, the EMA
    shadow under the port's parameter names."""
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import flax_leaf, load_jax_variables
    from agdiff_torch.train.optimizer import param_partition

    with np.load(os.path.join(path, JAX_STATE_FILE)) as z:
        arrays = {k: z[k] for k in z.files}
    module = DualEncoderEpsNetwork(config.model)
    load_jax_variables(module, {c: _unflatten(arrays, c)
                                for c in ("params", "batch_stats")})
    labels = param_partition(module)
    paths = {name: flax_leaf(module, name)[1]
             for name, _ in module.named_parameters()}
    adams = {}
    for part in (GLOBAL, LOCAL):
        names = [n for n in paths if labels[n] == part]
        adams[part] = {
            "count": int(arrays[f"adam/{part}/count"]),
            "lr": float(arrays[f"adam/{part}/lr"]),
            **{m: [_torch_leaf(arrays, f"adam/{part}/{m}/"
                               + "/".join(paths[n]), paths[n])
                   for n in names] for m in ("mu", "nu")}}
    payload = {"module": module.state_dict(),
               "optimizer": {"adams": adams, "notfinite_count": int(
                   arrays.get("notfinite_count", 0))},
               "step": int(arrays["step"])}
    if any(k.startswith("ema_params/") for k in arrays):
        payload["ema"] = {n: _torch_leaf(arrays, "ema_params/"
                                         + "/".join(p), p)
                          for n, p in paths.items()}
    return payload


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint directory written by save_checkpoint, or a converted
    one of the JAX package -> the state file's entries plus config,
    iteration, avg_val_loss and both plateau states."""
    if unconverted(path):
        raise FileNotFoundError(UNCONVERTED.format(path=path))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    config = config_from_json(meta["config"])
    if os.path.isfile(os.path.join(path, JAX_STATE_FILE)):
        payload = _to(load_converted(path, config), map_location)
    else:
        payload = torch.load(os.path.join(path, STATE_FILE),
                             map_location=map_location, weights_only=False)
    return {**payload, "config": config,
            "iteration": meta["iteration"],
            "avg_val_loss": meta["avg_val_loss"],
            "plateau_global": PlateauState(**meta["plateau_global"]),
            "plateau_local": PlateauState(**meta["plateau_local"])}


def _to(obj, device):
    """Every tensor in a nested dict or list moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to(v, device) for v in obj]
    return obj


def load_best(log_dir: str, map_location="cpu") -> Dict[str, Any]:
    with open(os.path.join(log_dir, "best_model", "POINTER")) as f:
        return load_checkpoint(f.read().strip(), map_location)
