"""The comparison that decides `correct`, shared by the traffic kinds.

The program's ladder keeps its positions after every block of S steps
(S the noise block, 20). For a sample of the window's conformers drawn
from the seed, the plain reference (port_bench/reference) follows the
program block by block: block k starts from the program's own positions
after block k - 1 (block 0 from the start the reference works out from
the seeds), with the same molecules, weights and ladder noise, and ends
where the program's block ought to end. It does so in float32 (TF32 off)
and at the precision the configuration states (`STATED`: bf16 products
and positions, in reference/agdiff.py's rounding places). A conformer's
gap is the RMS over blocks and atoms of the distance between the
program's positions after a block and float32's; its `block_ratio` is
that gap over the stated precision's gap, from the same states. The
number compared, `block_ratio`, is the 0.9 quantile of the sample's
ratios: about 1 where the program rounds as the stated precision does,
and it lets a fault in a tenth of the conformers show. Following the
program's own state keeps each comparison to S steps, where the
5000-step ladder amplifies rounding by factors that differ by orders of
magnitude from seed to seed (PERF.md). The control puts the reference
one precision step below (`CONTROL`: fp8 for bf16) in the program's
place: its blocks start from the same states.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

STATED = {"bfloat16": "bf16"}
CONTROL = {"bfloat16": "fp8"}


def quantizer(name: Optional[str]) -> Optional[Callable]:
    """Round a tensor to `name` and back to float32: bf16, fp8 (e4m3 with
    one scale a tensor, its largest magnitude at 448), or None."""
    if name is None:
        return None
    if name == "bf16":
        return lambda x: x.to(torch.bfloat16).float()
    if name == "fp8":
        def fp8(x):
            scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return fp8
    raise ValueError(f"unknown precision {name!r}")


class no_tf32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def gaps(got: np.ndarray, want: np.ndarray, atoms: List[int]
         ) -> List[float]:
    """Per conformer r, the RMS over blocks and its `atoms[r]` atoms of
    the distance between got[:, r] and want[:, r] ((blocks, R, N, 3))."""
    out = []
    for r, n in enumerate(atoms):
        d = ((got[:, r, :n].astype(np.float64)
              - want[:, r, :n].astype(np.float64)) ** 2).sum(-1)
        gap = math.sqrt(float(d.mean()))
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def p90(values: List[float]) -> float:
    return float(np.quantile(np.asarray(values, np.float64), 0.9))


def judge(program: np.ndarray, reference: Callable, dtype: str,
          atoms: List[int], control: Optional[str] = None) -> dict:
    """`reference(precision)` gives the sample's positions after every
    block ((blocks, R, N, 3)), each block started from the program's
    positions after the one before, at `precision` (None: float32; see
    `quantizer`); `program` the program's own, or with `control` the
    reference at that precision in their place; `atoms` each
    conformer's atom count."""
    if dtype not in STATED:
        raise ValueError(f"no stated precision for dtype {dtype!r}")
    with no_tf32():
        f32 = reference(None)
        base = reference(STATED[dtype])
        cand = program if control is None else reference(control)
    g, g_base = gaps(cand, f32, atoms), gaps(base, f32, atoms)
    ratios = [a / b if b > 0 else (0.0 if a == 0 else math.inf)
              for a, b in zip(g, g_base)]
    return dict(number=p90(ratios), ratios=ratios, gaps=g, base_gaps=g_base)
