"""Convert checkpoints of the JAX package (orbax) into files the PyTorch
port reads without jax.

Usage (on a machine with jax, flax, optax and orbax installed, from the
repository's root):

  python convert_jax_checkpoint.py <jax log dir | checkpoint dir> \\
      [--iter N] [--all]

A log dir converts its latest checkpoint (`--iter N`: iteration N;
`--all`: every one); a checkpoint directory (`<log dir>/checkpoints/<it>`)
converts itself. Each checkpoint is read with the JAX package's own
`agdiff_tpu.train.checkpoint.load_checkpoint(path, target=...)` against a
template TrainState of the config in its meta.json (the template keeps
optax's NamedTuples; a restore without one returns them as plain
containers), and written as one numpy file, `state.npz`, beside the orbax
`state/` directory. Nothing the JAX package wrote is changed or removed:
the file is added, through a temporary name.

The layout of state.npz, keys "/"-joined:

  params/<flax path>         the parameters, flax's shapes (kernels (in, out))
  batch_stats/<flax path>    the BatchNorm running statistics
  ema_params/<flax path>     the EMA shadow, when the run keeps one
  adam/<part>/count          ScaleByAdamState.count, part 'global' or 'local'
  adam/<part>/lr             the learning rate optax.inject_hyperparams holds
  adam/<part>/mu/<flax path> the first moment of each leaf of the part
  adam/<part>/nu/<flax path> the second moment
  notfinite_count            optax.apply_if_finite's count, when it wraps
  step                       the train state's step

This is the one file of the port that imports jax; the port itself
(agdiff_torch/train/checkpoint.py) reads the npz with numpy and torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np

STATE_NPZ = "state.npz"
PARTS = ("global", "local")


def _join(path) -> str:
    """A flattened path of nested dicts (jax DictKeys) as "a/b/c"."""
    return "/".join(str(k.key) for k in path)


def _flat(prefix: str, tree, out: Dict[str, np.ndarray]) -> None:
    """Every array leaf of a nested dict under `prefix/<path>`; optax's
    masked-out leaves (MaskedNode, no array) are skipped."""
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(leaf, "shape"):
            out[f"{prefix}/{_join(path)}"] = np.asarray(leaf)


def _find(state, attr: str):
    """The first state inside `state` (NamedTuples and tuples) that has
    `attr`."""
    if hasattr(state, attr):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _find(s, attr)
            if found is not None:
                return found
    return None


def optimizer_arrays(opt_state) -> Dict[str, np.ndarray]:
    """The arrays of the JAX package's optimizer state (train/optimizer.py
    make_optimizer: [apply_if_finite] chain(clip_by_global_norm,
    multi_transform({global, local}: [add_decayed_weights,]
    inject_hyperparams(adam)))) in state.npz's layout."""
    out: Dict[str, np.ndarray] = {}
    if hasattr(opt_state, "notfinite_count"):
        out["notfinite_count"] = np.asarray(opt_state.notfinite_count)
        opt_state = opt_state.inner_state
    _, multi = opt_state
    for part in PARTS:
        injected = _find(multi.inner_states[part].inner_state, "hyperparams")
        adam = _find(injected.inner_state, "mu")
        out[f"adam/{part}/count"] = np.asarray(adam.count)
        out[f"adam/{part}/lr"] = np.asarray(
            injected.hyperparams["learning_rate"], np.float32)
        _flat(f"adam/{part}/mu", adam.mu, out)
        _flat(f"adam/{part}/nu", adam.nu, out)
    return out


def state_arrays(ckpt) -> Dict[str, np.ndarray]:
    """A restored checkpoint (load_checkpoint's dict) in state.npz's
    layout."""
    out: Dict[str, np.ndarray] = {"step": np.asarray(ckpt["step"])}
    _flat("params", ckpt["params"], out)
    _flat("batch_stats", ckpt["batch_stats"], out)
    if ckpt.get("ema_params") is not None:
        _flat("ema_params", ckpt["ema_params"], out)
    out.update(optimizer_arrays(ckpt["opt_state"]))
    return out


def template_state(config):
    """A TrainState of `config` with the shapes, dtypes and optax
    structure a checkpoint of it holds, as host zeros: the init is traced
    (jax.eval_shape), never compiled."""
    import jax

    from agdiff_tpu.train.train_step import create_train_state

    n = max(config.buckets.max_nodes)
    shapes = jax.eval_shape(
        lambda key: create_train_state(config, key, n,
                                       config.train.batch_size)[1],
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


def convert(path: str) -> str:
    """Convert the checkpoint directory `path`; returns the npz's path."""
    from agdiff_tpu.config import config_from_json
    from agdiff_tpu.train.checkpoint import load_checkpoint

    if not os.path.isdir(os.path.join(path, "state")):
        raise FileNotFoundError(f"{path} holds no orbax state/ directory")
    with open(os.path.join(path, "meta.json")) as f:
        config = config_from_json(json.load(f)["config"])
    ckpt = load_checkpoint(path, target=template_state(config))
    out = os.path.join(path, STATE_NPZ)
    tmp = out + ".tmp.npz"
    np.savez_compressed(tmp, **state_arrays(ckpt))
    os.replace(tmp, out)
    return out


def checkpoint_dirs(path: str, it=None, every: bool = False) -> List[str]:
    """The checkpoint directories to convert under a log dir, or `path`
    itself when it is one."""
    d = os.path.join(path, "checkpoints")
    if not os.path.isdir(d):
        return [path]
    iters = sorted(int(n) for n in os.listdir(d) if n.isdigit())
    if not iters:
        raise FileNotFoundError(f"no checkpoints in {d}")
    if every:
        chosen = iters
    elif it is not None:
        if it not in iters:
            raise FileNotFoundError(f"iteration {it} not found in {d}")
        chosen = [it]
    else:
        chosen = iters[-1:]
    return [os.path.join(d, str(i)) for i in chosen]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="a JAX log dir or one checkpoint directory")
    ap.add_argument("--iter", type=int, default=None,
                    help="the log dir's iteration to convert (default: "
                         "the latest)")
    ap.add_argument("--all", action="store_true",
                    help="convert every checkpoint of the log dir")
    args = ap.parse_args(argv)
    for ckpt in checkpoint_dirs(args.path, args.iter, args.all):
        print(f"wrote {convert(ckpt)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
