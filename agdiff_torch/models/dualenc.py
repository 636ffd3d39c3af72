"""DualEncoderEpsNetwork, the dense module forward (port of
agdiff_tpu/models/dualenc.py).

This module path is the numerical anchor of the port. It computes at the
config's compute dtype, as the JAX module does: the parameters stay f32;
at `config.dtype` bfloat16 the positions are cast to bf16 before the
distances (so the radius mask is taken on bf16 distances), every layer
casts its input and parameters to bf16 (nn/common.py), and only the two
score planes and the edge lengths come out as f32
(agdiff_tpu/models/dualenc.py:54-55, 81-82, 190-195). The fast engines
(models/fast_forward.py, tight_forward.py, mono_forward.py) read the
module's f32 parameters and choose their own compute dtype. The module is
held against the JAX module's `apply(..., train=False)` by
tests/test_torch_port_model.py (f32) and tests/test_torch_port_bf16.py
(bf16), and in train mode against `apply(..., train=True,
mutable=["batch_stats"])` and its gradients by
tests/test_torch_port_train.py and tests/test_torch_port_bf16.py.
Submodule and parameter names follow the flax scopes, so
models/weights.py maps a JAX variables tree onto it one to one.

`train=True` normalises with batch statistics and moves the running ones
(nn/common.py::MaskedBatchNorm); the default, False, leaves them as they
are, so no generation path depends on the module's training flag.
`config.packed_pairs` puts every per-edge tensor on the bucket's N(N-1)/2
unordered pairs and mirrors the two score planes back to (B, N, N)
(agdiff_tpu/models/dualenc.py:104-120); `config.remat` recomputes both
encoders in backward (torch.utils.checkpoint), the running statistics
moving once per forward. Under spatial sharding (`nodes`, mode 'sp' of
parallel/sharded.py) the same modules run on this rank's node rows: the
pair ops take their j side from gathered node tensors and the planes come
out as row blocks; without a layout every module computes what it did.
`packed_pairs` under a layout puts the per-edge tensors on the rank's
owned pairs (ops/pairs.py owned_pairs): messages and scores reach both
endpoints through one reduce-scatter a layer, and the planes are the row
blocks the dense sp step gives.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from agdiff_torch.config import ModelConfig
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.nn.common import frozen_running_stats
from agdiff_torch.nn.edge_encoders import get_edge_encoder
from agdiff_torch.nn.gin import GINEncoder
from agdiff_torch.nn.mlp import MultiLayerPerceptron
from agdiff_torch.nn.schnet import SchNetEncoder
from agdiff_torch.ops.graph import working_graph
from agdiff_torch.ops.pairs import (
    PairList,
    gather_endpoints,
    mirror_plane,
    owned_pairs,
    pack_plane,
    triu_pairs,
)


class ModelOutput(NamedTuple):
    edge_inv_global: torch.Tensor  # (B, N, N) distance score, global branch
    edge_inv_local: torch.Tensor   # (B, N, N) distance score, local branch
    edge_mask: torch.Tensor        # (B, N, N) bool working-graph edges
    edge_type: torch.Tensor        # (B, N, N) int64
    edge_length: torch.Tensor      # (B, N, N) distances
    local_mask: torch.Tensor       # (B, N, N) bool bond-graph edges


class DualEncoderEpsNetwork(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        h = cfg.hidden_dim
        dt = self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                                   else torch.float32)
        self.edge_encoder_global = get_edge_encoder(cfg, dt)
        if not cfg.tie_edge_encoders:
            self.edge_encoder_local = get_edge_encoder(cfg, dt)
        self.encoder_global = SchNetEncoder(
            h, cfg.num_convs, cfg.cutoff, cfg.smooth_conv,
            cfg.embedding_max_norm, dtype=dt)
        self.encoder_local = GINEncoder(h, cfg.num_convs_local, dtype=dt)
        self.grad_global_dist_mlp = MultiLayerPerceptron(
            2 * h, (h, h // 2, 1), cfg.mlp_act, dtype=dt)
        self.grad_local_dist_mlp = MultiLayerPerceptron(
            2 * h, (h, h // 2, 1), cfg.mlp_act, dtype=dt)

    def forward(self, batch: GraphBatch, *, train: bool = False,
                extend_order: bool = False, extend_radius: bool = True,
                nodes=None) -> ModelOutput:
        """train: batch statistics, running ones moved (see the module
        docstring); extend_order extends the bond adjacency here (it is
        normally extended on the host); extend_radius=False takes the bond
        graph alone (agdiff_tpu/models/dualenc.py:66-95). `nodes`, a node
        layout (parallel/mesh.py NodeLayout, spatial sharding): the batch
        holds this rank's node rows, and the output planes are their row
        blocks (B, k, N)."""
        cfg = self.config
        node_mask = batch.node_mask
        dist, edge_mask, edge_type, local_mask = working_graph(
            batch, cfg.cutoff, cfg.edge_order, extend_order=extend_order,
            extend_radius=extend_radius, dtype=self.compute_dtype,
            nodes=nodes)
        pairs = None
        if cfg.packed_pairs:
            pairs = (_triu(dist.shape[-1], dist.device) if nodes is None
                     else owned_pairs(nodes, dist.device))
            edge_length = pack_plane(dist, pairs)[..., None]
            em_in = pack_plane(edge_mask, pairs)
            lm_in = pack_plane(local_mask, pairs)
            et_in = pack_plane(edge_type, pairs)
        else:
            edge_length = dist[..., None]
            em_in, lm_in, et_in = edge_mask, local_mask, edge_type
        e_global = self.edge_encoder_global(edge_length, et_in)
        e_local = (e_global if cfg.tie_edge_encoders
                   else self.edge_encoder_local(edge_length, et_in))

        h = self._encode(self.encoder_global, batch.atom_type, node_mask,
                         em_in, edge_length, e_global, train, pairs, nodes)
        inv_global = self.grad_global_dist_mlp(
            _pair_feature(h, e_global, pairs, nodes), train)[..., 0]
        hl = self._encode(self.encoder_local, batch.atom_type, node_mask,
                          lm_in, e_local, train, pairs, nodes)
        inv_local = self.grad_local_dist_mlp(
            _pair_feature(hl, e_local, pairs, nodes), train)[..., 0]
        if pairs is not None:
            # the diagonal gets pair 0's value, as in the dense path's
            # h_i * h_i diagonal: every consumer masks it
            inv_global = mirror_plane(inv_global, pairs)
            inv_local = mirror_plane(inv_local, pairs)
        return ModelOutput(
            edge_inv_global=inv_global.float(),
            edge_inv_local=inv_local.float(),
            edge_mask=edge_mask, edge_type=edge_type,
            edge_length=dist.float(), local_mask=local_mask,
        )

    def _encode(self, encoder, *args):
        """encoder(*args), recomputed in backward under config.remat (the
        recomputation normalises as the forward did and leaves the running
        statistics alone)."""
        if not (self.config.remat and torch.is_grad_enabled()):
            return encoder(*args)
        return checkpoint(encoder, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_running_stats()))


@functools.lru_cache(maxsize=8)
def _triu(n: int, device) -> PairList:
    """The bucket's triu pair list, built on the host once per size."""
    return triu_pairs(n, device)


def _pair_feature(node_attr, edge_attr, pairs=None, nodes=None):
    """concat(h_i * h_j, e_ij) over the dense pair block (a node layout's
    row block, h_j from the gathered axis), or over the pairs of a packed
    layout."""
    if pairs is not None:
        hi, hj = gather_endpoints(node_attr, pairs)
        prod = hi * hj
    else:
        hj = node_attr if nodes is None else nodes.gather(node_attr)
        prod = node_attr[:, :, None, :] * hj[:, None, :, :]
    return torch.cat([prod, edge_attr], dim=-1)
