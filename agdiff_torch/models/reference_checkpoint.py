"""Reference PyTorch AGDIFF checkpoints in the port (port of
agdiff_tpu/train/import_torch.py:102-331).

The reference saves `torch.save({"model": state_dict, "config": EasyDict,
...})` (scripts/train.py:218-231). Its module tree differs from the port's
(whose names follow the JAX package's flax scopes, models/dualenc.py) only
in names, so a reference tensor lands on a port tensor as it is:

  edge_encoder_*.{edge_feature_mlp,combination_mlp,attention}.{0,2}
                                           -> ..._0, ..._1
  encoder_global.interactions.N.convK.nn.{0,1.beta,2}
                                           -> interactions_N.convK.
                                              {filter_0,filter_act.beta,
                                               filter_1}
  encoder_global.interactions.N.attention.{0,2} -> attention_{0,1}
  encoder_global.scaling_modules.N.fc.{0,2} -> scaling_modules_N.fc_{0,1}
  encoder_local.convs.N.nn.layers.M        -> convs_N.nn.layers_M
  encoder_local.batch_norms.N              -> batch_norms_N
  grad_*_dist_mlp.layers.M                 -> layers_M

Loading is strict: every port parameter and buffer is set once, and every
checkpoint key is consumed or is one of the documented dead keys of a
real checkpoint (tests/test_reference_checkpoint_keys.py:154-163): the
schedule buffers betas and alphas, the never-trained edge_encoder_local
when the encoders are tied, the CFConv attention_weights, BatchNorm
num_batches_tracked and the GINEConv eps buffers. Any other key raises.
"""

from __future__ import annotations

import dataclasses
import pickle
import re
import types
from typing import Dict, Optional, Tuple

import torch

from agdiff_torch.config import ModelConfig
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.schedules import get_beta_schedule

# (pattern, replacement) applied in order to a reference key
_RENAMES = (
    (r"\.(edge_feature_mlp|combination_mlp|attention)\.0\.", r".\1_0."),
    (r"\.(edge_feature_mlp|combination_mlp|attention)\.2\.", r".\1_1."),
    (r"\.(interactions|scaling_modules|convs|batch_norms|layers)\.(\d+)\.",
     r".\1_\2."),
    (r"\.nn\.0\.", ".filter_0."),
    (r"\.nn\.1\.beta$", ".filter_act.beta"),
    (r"\.nn\.2\.", ".filter_1."),
    (r"\.fc\.0\.", ".fc_0."),
    (r"\.fc\.2\.", ".fc_1."),
)
# the inverse, for export (port key -> reference key)
_INVERSE = (
    (r"\.(edge_feature_mlp|combination_mlp|attention)_0\.", r".\1.0."),
    (r"\.(edge_feature_mlp|combination_mlp|attention)_1\.", r".\1.2."),
    (r"\.(interactions|scaling_modules|convs|batch_norms|layers)_(\d+)\.",
     r".\1.\2."),
    (r"\.filter_0\.", ".nn.0."),
    (r"\.filter_act\.beta$", ".nn.1.beta"),
    (r"\.filter_1\.", ".nn.2."),
    (r"\.fc_0\.", ".fc.0."),
    (r"\.fc_1\.", ".fc.2."),
)


def _rename(key: str, rules) -> str:
    for pattern, repl in rules:
        key = re.sub(pattern, repl, key)
    return key


def is_documented_dead(key: str, tied: bool = True) -> bool:
    """Keys of a real checkpoint that carry no compute in the reference
    forward (tests/test_reference_checkpoint_keys.py:154-163)."""
    return (key in ("betas", "alphas")
            or (tied and key.startswith("edge_encoder_local."))
            or key.endswith(".attention.attention_weights")
            or key.endswith(".num_batches_tracked")
            or (key.startswith("encoder_local.convs.")
                and key.endswith(".eps")))


def load_reference_state_dict(module: DualEncoderEpsNetwork,
                              state_dict: Dict[str, torch.Tensor]) -> None:
    """Copy a reference state_dict into `module`, strictly (see the module
    docstring); raises KeyError on an unknown key or an unset port tensor,
    ValueError on a shape mismatch."""
    tied = module.config.tie_edge_encoders
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    unset = set(targets)
    for key, value in state_dict.items():
        port_key = _rename(key, _RENAMES)
        if port_key not in targets:
            if is_documented_dead(key, tied):
                continue
            raise KeyError(f"reference key {key!r} has no port counterpart "
                           f"and is not a documented dead key")
        dst = targets[port_key]
        value = torch.as_tensor(value)
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the port "
                             f"expects {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(value.to(dst.dtype))
        unset.discard(port_key)
    if unset:
        raise KeyError(f"port tensors the checkpoint does not set: "
                       f"{sorted(unset)}")


class _EasyDictShim(dict):
    def __setstate__(self, state):
        self.update(state if isinstance(state, dict) else {})


class _Unpickler(pickle.Unpickler):
    """Reads the reference's pickled EasyDict config without easydict."""

    def find_class(self, module, name):
        if module.startswith("easydict"):
            return _EasyDictShim
        return super().find_class(module, name)


_PICKLE = types.SimpleNamespace(__name__="pickle", Unpickler=_Unpickler,
                                load=pickle.load)


def load_reference_checkpoint(path: str,
                              module: Optional[DualEncoderEpsNetwork] = None
                              ) -> Tuple[DualEncoderEpsNetwork, ModelConfig]:
    """A reference .pt checkpoint -> (module in eval mode, ModelConfig). The
    model config comes from the checkpoint's config['model'] (keys the port
    does not know are ignored); `module`, when given, is loaded instead of
    a new one. On the CPU; move the module where it runs."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PICKLE)
    raw = dict(ckpt["config"]["model"]) if "config" in ckpt else {}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    config = ModelConfig(**{k: v for k, v in raw.items() if k in known})
    if module is None:
        module = DualEncoderEpsNetwork(config)
    load_reference_state_dict(module, ckpt["model"])
    return module.eval(), config


def export_reference_state_dict(module: DualEncoderEpsNetwork,
                                config: Optional[ModelConfig] = None
                                ) -> Dict[str, torch.Tensor]:
    """The port's module -> a reference-layout state_dict with every key of
    the real module tree, which the reference strict-loads
    (import_torch.py:203-331): a copy of the global edge encoder as
    edge_encoder_local when tied, zero CFConv attention_weights and GINEConv
    eps, num_batches_tracked 0, and the schedule buffers betas (f32) and
    alphas = cumprod(1 - betas) in f32."""
    cfg = config or module.config
    out: Dict[str, torch.Tensor] = {}
    for key, value in module.state_dict().items():
        ref_key = _rename(key, _INVERSE)
        out[ref_key] = value.detach().cpu().clone()
        if ref_key.endswith(".running_var"):
            out[ref_key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    if cfg.tie_edge_encoders:
        for key in [k for k in out if k.startswith("edge_encoder_global.")]:
            out["edge_encoder_local." + key[len("edge_encoder_global."):]] = \
                out[key].clone()
    h = cfg.hidden_dim
    for i in range(cfg.num_convs):
        dst = f"encoder_global.interactions.{i}"
        out[f"{dst}.conv1.attention.attention_weights"] = torch.zeros(h)
        out[f"{dst}.conv2.attention.attention_weights"] = torch.zeros(h // 2)
    for i in range(cfg.num_convs_local):
        out[f"encoder_local.convs.{i}.eps"] = torch.zeros(1)
    betas = torch.from_numpy(get_beta_schedule(
        cfg.beta_schedule, beta_start=cfg.beta_start, beta_end=cfg.beta_end,
        num_diffusion_timesteps=cfg.num_diffusion_timesteps
    ).astype("float32"))
    out["betas"] = betas
    out["alphas"] = torch.cumprod(1.0 - betas, dim=0)
    return out
