"""K3, K4 and K5, the dense-layout edge consumers of engine 'pallas', for
Hopper (port of agdiff_tpu/ops/pallas/fused.py).

* `interaction_block_aggregate` (K3) replaces `_block_agg_kernel`
  (fused.py:181, entered through `interaction_block_aggregate` :206): both
  CFConv pathways of one interaction block on the dense (B, N, N, C) edge
  features,
      v = ssp(e @ fa + ba),  ssp(x) = softplus(beta x) - ln 2,
      t = v @ fb + bb,
      out[b, i, f] = sum_j t[b, i, j, f] w[b, i, j] h[b, j, f],
  for (w_edge1, h1, conv1) and (w_edge2, h2, conv2). The products take
  operands of e's dtype with an f32 accumulator (v is rounded to it
  before the second product; the weights are cast to it); the rest is f32
  and unrounded. Rows with w = 0 are multiplied, not skipped.
* `pair_score_mlp` (K4) replaces `_pair_score_kernel` (fused.py:82,
  entered through `pair_score_mlp` :106): s[b, i, j] =
  MLP3(concat(h_i h_j, e_ij)), zero off the mask. h_i h_j is taken at h's
  dtype (rounded when bf16); x = act([h_i h_j | e] @ w1 + b1) with an f32
  accumulator, rounded to the weights' dtype; y = act(x @ w2 + b2) in f32;
  s = sum_c y[c] w3[c] + b3 in f32. The weights are taken at h's dtype, as
  the JAX engine casts them; the biases stay f32.
* `gine_aggregate` (K5) replaces `_gine_kernel` (fused.py:142, entered
  through `gine_aggregate` :153): out[b, i] = sum_j mask_ij relu(x_j +
  e_ij), in f32. The JAX engine calls it at f32 only
  (agdiff_tpu/models/fast_forward.py:753-758), and so does this kernel.

Each function has a `*_plain` twin in PyTorch. The wrapper runs the twin
for CPU tensors and launches the CUDA kernel (csrc/fused.cu, built at first
use) for CUDA tensors, or raises for what the kernel does not take: a
dtype, a shape, a device mismatch, an activation other than relu. K5 is a
fused elementwise pass plus a reduction, which Triton could express; it is
CUDA C++ here too, so that the port has one build path. `launches` counts
the kernel launches per variant; the plain twins count nothing.

Design, bounds and what these first kernels leave on the table:
csrc/fused.cu.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch
import torch.nn.functional as F

from agdiff_torch.nn.common import activation_by_name

LN2 = math.log(2.0)
DTYPES = (torch.float32, torch.bfloat16)
MAX_FILTER_WIDTH = 256   # F1 + F2: one thread a column (csrc/fused.cu)

# kernel launches per variant ('<kernel>:<f32|bf16>'); plain calls do not
# count
launches: Counter = Counter()


def variant(kernel: str, dtype: torch.dtype) -> str:
    """Name of a launch variant, e.g. 'block_agg:bf16'."""
    return f"{kernel}:{'bf16' if dtype == torch.bfloat16 else 'f32'}"


def _dot(x, w, cd):
    """x @ w on operands rounded to cd, with an f32 result (an f32
    accumulator; a bf16 product is exact in f32)."""
    return x.to(cd).float() @ w.to(cd).float()


def filter_mlp(e, conv, softplus=F.softplus):
    """A CFConv filter MLP at e's dtype: (ssp(e @ fa + ba) rounded) @ fb +
    bb, in f32 (fused.py:192-196, block_packed.py:66-72)."""
    cd = e.dtype
    v = _dot(e, conv["fa"][0], cd) + conv["fa"][1]
    v = softplus(conv["beta"] * v) - LN2
    return _dot(v, conv["fb"][0], cd) + conv["fb"][1]


# ---- plain versions ----------------------------------------------------------

def interaction_block_aggregate_plain(edge_attr, w_edge1, w_edge2, h1, h2,
                                      conv1, conv2):
    """Plain PyTorch version of K3: (agg1 (B, N, F1), agg2 (B, N, F2))
    f32."""
    out = []
    for w_edge, conv, h in ((w_edge1, conv1, h1), (w_edge2, conv2, h2)):
        t = filter_mlp(edge_attr, conv) * w_edge[..., None]
        out.append((t * h[:, None].float()).sum(2))
    return tuple(out)


def pair_score_mlp_plain(h, edge_attr, edge_mask, w1, b1, w2, b2, w3, b3,
                         activation: str = "relu"):
    """Plain PyTorch version of K4: (B, N, N) f32."""
    cd = h.dtype
    act = activation_by_name(activation)
    c = h.shape[-1]
    w1, w2, w3 = w1.to(cd), w2.to(cd), w3.to(cd)
    prod = h[:, :, None, :] * h[:, None, :, :]
    x = act(_dot(prod, w1[:c], cd) + _dot(edge_attr, w1[c:], cd) + b1)
    y = act(_dot(x, w2, cd) + b2)
    s = (y * w3[:, 0].float()).sum(-1) + b3.float()[0]
    return torch.where(edge_mask, s, torch.zeros((), device=s.device))


def gine_aggregate_plain(x, edge_attr, local_mask):
    """Plain PyTorch version of K5: (B, N, C) f32."""
    msg = torch.relu(x[:, None].float() + edge_attr.float())
    return (msg * local_mask[..., None].float()).sum(2)


# ---- wrappers ----------------------------------------------------------------

def interaction_block_aggregate(edge_attr, w_edge1, w_edge2, h1, h2, conv1,
                                conv2):
    """K3. edge_attr (B, N, N, C) f32 or bf16; w_edge1/2 (B, N, N) f32;
    h1 (B, N, F1), h2 (B, N, F2) f32; conv dicts with fa, beta, fb as
    models/fast_forward.fold_eval_params makes them. Returns (agg1, agg2)
    f32."""
    if edge_attr.device.type == "cpu":
        return interaction_block_aggregate_plain(
            edge_attr, w_edge1, w_edge2, h1, h2, conv1, conv2)
    dev, cd = _device_and_dtype(edge_attr, "edge_attr")
    b, n, n2, c = edge_attr.shape
    f1, f2 = conv1["fb"][0].shape[1], conv2["fb"][0].shape[1]
    if n2 != n:
        raise ValueError(f"edge_attr shape {tuple(edge_attr.shape)} is not "
                         f"(B, N, N, C)")
    if c % 4 or f1 % 4 or f2 % 4 or f1 + f2 > MAX_FILTER_WIDTH:
        raise ValueError(f"kernel needs C, F1, F2 % 4 == 0 and F1 + F2 <= "
                         f"{MAX_FILTER_WIDTH} (C={c}, F1={f1}, F2={f2})")
    check("edge_attr", edge_attr, (b, n, n, c), cd, dev)
    check("w_edge1", w_edge1, (b, n, n), torch.float32, dev)
    check("w_edge2", w_edge2, (b, n, n), torch.float32, dev)
    check("h1", h1, (b, n, f1), torch.float32, dev)
    check("h2", h2, (b, n, f2), torch.float32, dev)
    wts = filter_weights(conv1, conv2, c, cd, dev)
    out1 = torch.empty((b, n, f1), dtype=torch.float32, device=dev)
    out2 = torch.empty((b, n, f2), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.block_agg_launch(
        int(cd == torch.bfloat16), *_ptrs(edge_attr, w_edge1, w_edge2, h1,
                                          h2), _ptr_array(wts),
        *_ptrs(out1, out2), b, n, c, f1, f2, _stream(dev))
    _raise_on(lib, err, "block_agg")
    launches[variant("block_agg", cd)] += 1
    return out1, out2


def pair_score_mlp(h, edge_attr, edge_mask, w1, b1, w2, b2, w3, b3,
                   activation: str = "relu"):
    """K4. h (B, N, C) and edge_attr (B, N, N, C) at one dtype (f32 or
    bf16); edge_mask (B, N, N) bool; w1 (2C, H1) (rows [0, C) take h_i h_j,
    [C, 2C) e_ij), w2 (H1, H2), w3 (H2, 1), taken at h's dtype; biases
    f32. Returns (B, N, N) f32."""
    if h.device.type == "cpu":
        return pair_score_mlp_plain(h, edge_attr, edge_mask, w1, b1, w2, b2,
                                    w3, b3, activation)
    dev, cd = _device_and_dtype(h, "h")
    if activation != "relu":
        raise NotImplementedError("the CUDA kernel implements relu heads")
    b, n, c = h.shape
    h1, h2 = w1.shape[1], w2.shape[1]
    if c % 4 or h1 % 4 or h2 % 4:
        raise ValueError(f"kernel needs C, H1, H2 % 4 == 0 (C={c}, H1={h1}, "
                         f"H2={h2})")
    check("h", h, (b, n, c), cd, dev)
    check("edge_attr", edge_attr, (b, n, n, c), cd, dev)
    check("edge_mask", edge_mask, (b, n, n), torch.bool, dev)
    wts = [weight(w1, (2 * c, h1), cd, dev), weight(b1, (h1,), None, dev),
           weight(w2, (h1, h2), cd, dev), weight(b2, (h2,), None, dev),
           weight(w3, (h2, 1), cd, dev), weight(b3, (1,), None, dev)]
    out = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.pair_score_launch(
        int(cd == torch.bfloat16), *_ptrs(h, edge_attr, edge_mask),
        _ptr_array(wts), out.data_ptr(), b, n, c, h1, h2, _stream(dev))
    _raise_on(lib, err, "pair_score")
    launches[variant("pair_score", cd)] += 1
    return out


def gine_aggregate(x, edge_attr, local_mask):
    """K5. x (B, N, C) and edge_attr (B, N, N, C) f32; local_mask (B, N, N)
    bool. Returns (B, N, C) f32."""
    if x.device.type == "cpu":
        return gine_aggregate_plain(x, edge_attr, local_mask)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gine_aggregate: unsupported device {dev}")
    b, n, c = x.shape
    if c % 4:
        raise ValueError(f"kernel needs C % 4 == 0 (C={c})")
    # f32 only, as the JAX engine calls it (fast_forward.py:753-758)
    check("x", x, (b, n, c), torch.float32, dev, align=16)
    check("edge_attr", edge_attr, (b, n, n, c), torch.float32, dev,
          align=16)
    check("local_mask", local_mask, (b, n, n), torch.bool, dev)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.gine_launch(*_ptrs(x, edge_attr, local_mask, out), b, n, c,
                          _stream(dev))
    _raise_on(lib, err, "gine")
    launches[variant("gine", torch.float32)] += 1
    return out


# ---- launch helpers (also used by kernels/block_packed.py) -------------------

def check(name, t, shape, dtype, device, align: int = 0):
    """Raise unless t lies on `device` with this dtype and shape,
    contiguous (and its data `align`-byte aligned)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")


def weight(t, shape, dtype, device):
    """A weight, bias or scalar as the kernel reads it: on `device`,
    contiguous, at `dtype` (None: f32). A no-op for a weight prepared so
    (models/fast_forward.py); raises for another shape or device, or for
    data that is not 16-byte aligned (vector loads)."""
    t = torch.as_tensor(t)
    if t.device != device:
        raise ValueError(f"a weight lies on {t.device}, expected {device}")
    if t.numel() != math.prod(shape) or (t.dim() and tuple(t.shape) !=
                                         tuple(shape)):
        raise ValueError(f"weight shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    t = t.detach().to(torch.float32 if dtype is None else dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError("a weight is not 16-byte aligned")
    return t


def filter_weights(conv1, conv2, c, cd, device):
    """fa1, fa2, fb1, fb2 at cd, then ba1, ba2, bb1, bb2, beta1, beta2 in
    f32: the order of the kernels' weight tables (csrc/filter_mlp.cuh
    FilterW)."""
    f1, f2 = conv1["fb"][0].shape[1], conv2["fb"][0].shape[1]
    return [weight(conv1["fa"][0], (c, f1), cd, device),
            weight(conv2["fa"][0], (c, f2), cd, device),
            weight(conv1["fb"][0], (f1, f1), cd, device),
            weight(conv2["fb"][0], (f2, f2), cd, device),
            weight(conv1["fa"][1], (f1,), None, device),
            weight(conv2["fa"][1], (f2,), None, device),
            weight(conv1["fb"][1], (f1,), None, device),
            weight(conv2["fb"][1], (f2,), None, device),
            weight(conv1["beta"], (1,), None, device),
            weight(conv2["beta"], (1,), None, device)]


def _device_and_dtype(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} dtype {t.dtype}: the kernel takes f32 or "
                        f"bf16")
    return t.device, t.dtype


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _ptr_array(ts):
    return (ctypes.c_void_p * len(ts))(*_ptrs(*ts))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.error_string(err).decode())


def _lib():
    from agdiff_torch.kernels import build

    lib = build.load("fused")
    if not getattr(lib, "_typed", False):
        p, i, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_void_p)
        lib.block_agg_launch.argtypes = [i] + [p] * 5 + [pp, p, p] \
            + [i] * 5 + [p]
        lib.pair_score_launch.argtypes = [i, p, p, p, pp, p] + [i] * 5 + [p]
        lib.gine_launch.argtypes = [p] * 4 + [i] * 3 + [p]
        for fn in (lib.block_agg_launch, lib.pair_score_launch,
                   lib.gine_launch):
            fn.restype = i
        lib.error_string = lib.fused_error_string
        lib.error_string.argtypes = [i]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
