"""Checkpoints (port of agdiff_tpu/train/checkpoint.py:26-131).

The JAX package's layout: <log_dir>/checkpoints/<iteration>/ holds the
state and a meta.json (the config as JSON, the iteration, avg_val_loss and
both plateau states), and <log_dir>/best_model/POINTER names the best
checkpoint's directory. The state is one `torch.save` file, state.pt: the
module's parameters and running statistics, both Adams' states, the step,
the step generator's state, the loader's draw state and, when the run
keeps one, the EMA shadow. The JAX package's orbax state directories
cannot be read here (reading them needs jax) and raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from agdiff_torch.config import Config, config_from_json, config_to_json
from agdiff_torch.train.optimizer import PlateauState

STATE_FILE = "state.pt"
ORBAX_REFUSAL = (
    "{path} is a checkpoint of the JAX package (an orbax state directory); "
    "the port cannot read it without jax (ROADMAP.md queue 1 item 4c, a "
    "converter run on the JAX side). Until then move its weights with the "
    "JAX package's export_reference_state_dict into a reference .pt "
    "(agdiff_tpu/train/import_torch.py), which the port reads")


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


def is_jax_checkpoint(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "state"))


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint directory written by save_checkpoint -> the state
    file's entries plus config, iteration, avg_val_loss and both plateau
    states."""
    if is_jax_checkpoint(path):
        raise NotImplementedError(ORBAX_REFUSAL.format(path=path))
    payload = torch.load(os.path.join(path, STATE_FILE),
                         map_location=map_location, weights_only=False)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return {**payload, "config": config_from_json(meta["config"]),
            "iteration": meta["iteration"],
            "avg_val_loss": meta["avg_val_loss"],
            "plateau_global": PlateauState(**meta["plateau_global"]),
            "plateau_local": PlateauState(**meta["plateau_local"])}


def load_best(log_dir: str, map_location="cpu") -> Dict[str, Any]:
    with open(os.path.join(log_dir, "best_model", "POINTER")) as f:
        return load_checkpoint(f.read().strip(), map_location)
