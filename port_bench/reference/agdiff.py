"""AGDIFF's eval forward and its annealed Langevin ladder in plain float32
PyTorch: the benchmark's reference, a frozen copy written from the
published model (ADicksonLab/AGDIFF: DualEncoderEpsNetwork with a
SchNet global encoder, a GIN local encoder over the order-3 bond graph, a
tied MLP edge encoder and two pair-score heads; the 'ld' sampler of its
scripts/test.py). It imports nothing of the program under test.

Weights come as a dict of tensors under the module names the benchmark
makes them by (port_bench/weights.py). Everything runs dense over a
(B, N) padded block, in float32 with TF32 off. `quant` (a function of a
tensor) rounds, at the places where a reduced-precision recipe rounds,
the positions the distances are taken from and every matrix product's
operands and result: bf16 there gives the reference at the precision the
configurations state (bf16 matrix products, float32 accumulation and
statistics), fp8 the lower-precision control of the correctness check.

Departures from the published code, each exact: the edge encoder's
"attention" is a softmax over an axis of length one, which is exactly 1,
and is left out; the bond-order extension is taken on the host once per
molecule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

NUM_BOND_TYPES = 22     # RDKit's bond types with UNSPECIFIED; k-hop: 22 + k - 1
EPS = 1e-12


def extend_bond_order(adj: np.ndarray, order: int = 3) -> np.ndarray:
    """(N, N) typed adjacency -> the same with k-hop pairs (2 <= k <=
    order) typed NUM_BOND_TYPES + k - 1."""
    one_hop = ((adj > 0) | np.eye(len(adj), dtype=bool)).astype(np.int64)
    reach, hop = one_hop, one_hop - np.eye(len(adj), dtype=np.int64)
    for k in range(2, order + 1):
        nxt = ((reach @ one_hop) > 0).astype(np.int64)
        hop = hop + (nxt - reach) * k
        reach = nxt
    return np.where(hop == 1, adj,
                    np.where(hop > 1, NUM_BOND_TYPES + hop - 1, 0))


class Model:
    """The eval forward over weights `w` for a config dict (hidden_dim,
    num_convs, num_convs_local, cutoff, smooth_conv, mlp_act,
    embedding_max_norm)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 quant: Optional[Callable] = None):
        self.w = {k: v.float() for k, v in w.items()}
        self.cfg, self.quant = cfg, quant
        self.wq = {k: quant(v) for k, v in self.w.items()
                   if k.endswith(".weight")} if quant else {}

    def lin(self, name, x, bias=True):
        if self.quant is None:
            y = x @ self.w[name + ".weight"].t()
        else:
            y = self.quant(self.quant(x) @ self.wq[name + ".weight"].t())
        return y + self.w[name + ".bias"] if bias else y

    def bn(self, name, x, mask):
        w = self.w
        y = ((x - w[name + ".running_mean"])
             * torch.rsqrt(w[name + ".running_var"] + 1e-5)
             * w[name + ".weight"] + w[name + ".bias"])
        return y * mask[..., None]

    def ssp(self, name, x):
        return F.softplus(self.w[name + ".beta"] * x) - math.log(2.0)

    def edge_encoder(self, d, etype):
        p = "edge_encoder_global."
        bond = self.w[p + "bond_emb.weight"][etype]
        x = F.gelu(self.lin(p + "feature_expansion", d), approximate="tanh")
        x = F.gelu(self.lin(p + "edge_feature_mlp_0",
                            torch.cat([x, bond], -1)), approximate="tanh")
        x = self.lin(p + "edge_feature_mlp_1", x)
        y = F.gelu(self.lin(p + "combination_mlp_0",
                            torch.cat([x, bond], -1)), approximate="tanh")
        return self.lin(p + "combination_mlp_1", y)

    def cfconv(self, p, x, mask, edge_mask, d, e):
        cutoff = self.cfg["cutoff"]
        if self.cfg["smooth_conv"]:
            env = 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0)
        else:
            env = torch.exp(-((d - cutoff) ** 2) / (2 * cutoff ** 2))
        env = env * (d <= cutoff)
        dw = torch.sigmoid(self.lin(p + "distance_weighting.layer2", torch.relu(
            self.lin(p + "distance_weighting.layer1", d))))
        filt = self.lin(p + "filter_1", self.ssp(
            p + "filter_act", self.lin(p + "filter_0", e))) * (dw * env)
        filt = filt * edge_mask[..., None]
        h = F.leaky_relu(self.bn(p + "norm1", self.lin(p + "lin1", x), mask),
                         0.2)
        out = torch.einsum("bijf,bjf->bif", filt, h)
        return self.bn(p + "norm2", self.lin(p + "lin2", out), mask)

    def schnet(self, z, mask, edge_mask, d, e):
        emb = self.w["encoder_global.embedding.weight"][z]
        max_norm = self.cfg.get("embedding_max_norm")
        if max_norm is not None:
            norm = emb.norm(dim=-1, keepdim=True)
            emb = emb * torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                                    max=1.0)
        h = emb
        for i in range(self.cfg["num_convs"]):
            p = f"encoder_global.interactions_{i}."
            c1 = self.cfconv(p + "conv1.", h, mask, edge_mask, d, e)
            c2 = self.cfconv(p + "conv2.", h, mask, edge_mask, d, e)
            comb = self.lin(p + "lin", self.ssp(p + "act",
                                                torch.cat([c1, c2], -1)))
            gate = torch.sigmoid(self.lin(p + "attention_1", torch.relu(
                self.lin(p + "attention_0", comb))))
            out = comb * gate
            s = f"encoder_global.scaling_modules_{i}."
            se = torch.sigmoid(self.lin(s + "fc_1", torch.relu(
                self.lin(s + "fc_0", out, bias=False)), bias=False))
            h = h + out * se
        return h

    def gin(self, z, mask, local_mask, e):
        act = torch.relu      # the GIN is relu whatever mlp_act says
        h = self.w["encoder_local.node_emb.weight"][z]
        n = self.cfg["num_convs_local"]
        for i in range(n):
            p = f"encoder_local.convs_{i}.nn."
            msg = act(h[:, None, :, :] + e)
            agg = torch.einsum("bij,bijh->bih", local_mask.float(), msg)
            x = self.lin(p + "layers_1", act(self.lin(p + "layers_0",
                                                      h + agg)))
            x = self.bn(f"encoder_local.batch_norms_{i}", x, mask)
            h = (act(x) if i < n - 1 else x) + h
        return h

    def act(self, x):
        if self.cfg["mlp_act"] == "relu":
            return torch.relu(x)
        return F.gelu(x, approximate="tanh")

    def head(self, name, h, e):
        x = torch.cat([h[:, :, None, :] * h[:, None, :, :], e], -1)
        x = self.act(self.lin(name + ".layers_0", x))
        x = self.act(self.lin(name + ".layers_1", x))
        return self.lin(name + ".layers_2", x)[..., 0]

    def forward(self, z, pos, mask, adj):
        """(score_global, score_local, edge_mask, local_mask, dist), each
        (B, N, N), for atom types z (B, N), positions (B, N, 3), the node
        mask (B, N) and the order-extended adjacency (B, N, N)."""
        n = z.shape[1]
        at = pos if self.quant is None else self.quant(pos)
        diff = at[:, :, None, :] - at[:, None, :, :]
        d = torch.sqrt((diff * diff).sum(-1) + EPS)
        pair = (mask[:, :, None] & mask[:, None, :]
                & ~torch.eye(n, dtype=torch.bool, device=z.device))
        local_mask = (adj > 0) & pair
        edge_mask = ((d <= self.cfg["cutoff"]) & pair) | local_mask
        etype = torch.where(edge_mask, adj, torch.zeros_like(adj))
        e = self.edge_encoder(d[..., None], etype)
        fmask = mask.float()
        h = self.schnet(z, fmask, edge_mask, d[..., None], e)
        hl = self.gin(z, fmask, local_mask, e)
        return (self.head("grad_global_dist_mlp", h, e),
                self.head("grad_local_dist_mlp", hl, e),
                edge_mask, local_mask, d)


def eq_transform(score, pos, mask, d):
    s = torch.where(mask, score, torch.zeros_like(score))
    w = (s + s.transpose(1, 2)) / torch.clamp(d, min=EPS)
    return torch.einsum("bij,bijc->bic", w,
                        pos[:, :, None, :] - pos[:, None, :, :])


def clip_norm(v, limit):
    norm = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                  min=EPS * EPS))
    return v * torch.where(norm > limit, limit / norm, torch.ones_like(norm))


def drift(model: Model, z, pos, mask, adj, gate, sampler: dict):
    """The assembled drift: the local score (clipped to clip_local), plus
    the global score off the bond graph, clipped to `clip`, times
    w_global where `gate` (a (1,) bool tensor: sigma below
    global_start_sigma)."""
    g, loc, edge_mask, local_mask, d = model.forward(z, pos, mask, adj)
    eps = eq_transform(loc, pos, local_mask, d)
    if sampler.get("clip_local") is not None:
        eps = clip_norm(eps, sampler["clip_local"])
    glob = clip_norm(eq_transform(g * (~local_mask).float(), pos,
                                  edge_mask, d), sampler["clip"])
    glob = torch.where(gate, glob, torch.zeros_like(glob))
    return eps + glob * sampler["w_global"]


def sigmas(diffusion: dict) -> np.ndarray:
    """The annealing ladder sqrt((1 - a) / a) of the config's schedule
    (betas in float64 cast to float32, a the float32 cumulative product
    of 1 - beta)."""
    t = diffusion["num_diffusion_timesteps"]
    if diffusion["beta_schedule"] != "sigmoid":
        raise ValueError("the reference holds the sigmoid schedule only")
    x = np.linspace(-6, 6, t)
    betas = (1.0 / (1.0 + np.exp(-x)) * (diffusion["beta_end"]
                                          - diffusion["beta_start"])
             + diffusion["beta_start"]).astype(np.float32)
    a = np.cumprod(1.0 - betas, dtype=np.float32)
    return np.sqrt(1.0 - a) / np.sqrt(a)


@torch.no_grad()
def ld_ladder(model: Model, z, mask, adj, start, noise_fn, diffusion: dict,
              sampler: dict, states=None):
    """The last n_steps levels of the schedule, highest first: pos =
    start * sigma_max, then per level pos += step * eps / sigma +
    sqrt(2 step) * xi with step = step_lr (sigma / 0.01)^2, non-finite
    entries zeroed and each graph re-centred. `noise_fn(k)` gives the
    (S, B, N, 3) noise of the ladder's k-th block of S = sampler['block']
    steps. Returns the positions after every block, (n_steps / S, B, N,
    3). With `states` (the same shape: another run's positions after each
    block), block k starts from states[k - 1] and block 0 from `start`,
    so that each block is followed from that run's own state. The
    per-step scalars are tables on the device read through a step
    counter, so that on a card one captured block of S steps (a CUDA
    graph of the same operations) serves every block."""
    dev = z.device
    sig = sigmas(diffusion)
    t, n_steps, size = len(sig), sampler["n_steps"], sampler["block"]
    if n_steps % size:
        raise ValueError(f"{n_steps} steps are not whole blocks of {size}")
    level = sig[t - 1 - np.arange(n_steps)].astype(np.float64)
    step = sampler["step_lr"] * (level / 0.01) ** 2
    table = lambda v, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(v), dtype=dt, device=dev)
    c_drift, c_noise = table(step / level), table(np.sqrt(2.0 * step))
    gates = table(level < sampler["global_start_sigma"], torch.bool)
    m3 = mask[..., None].float()
    count = torch.clamp(m3.sum(1, keepdim=True), min=1.0)
    pos = start * float(sig[t - 1]) * m3
    noise = torch.zeros((size,) + tuple(pos.shape), device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)

    def block():
        for i in range(size):
            eps = drift(model, z, pos, mask, adj, gates.index_select(0, k),
                        sampler)
            nxt = (pos + c_drift.index_select(0, k) * eps
                   + noise[i] * m3 * c_noise.index_select(0, k))
            nxt = torch.where(torch.isfinite(nxt), nxt, torch.zeros_like(nxt))
            pos.copy_((nxt - (nxt * m3).sum(1, keepdim=True) / count) * m3)
            k.add_(1)

    run = block
    if dev.type == "cuda":
        saved = pos.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            block()                     # fills every lazy state first
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            block()
        pos.copy_(saved)
        k.zero_()
        run = graph.replay
    ends = torch.zeros((n_steps // size,) + tuple(pos.shape), device=dev)
    for b in range(n_steps // size):
        if states is not None and b > 0:
            pos.copy_(states[b - 1] * m3)
        noise.copy_(noise_fn(b))
        run()
        ends[b].copy_(pos)
    return ends
