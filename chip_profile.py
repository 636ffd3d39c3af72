#!/usr/bin/env python3
"""Device time of the engine paths A ('pallas' f32), B ('pallas' bf16) and
D ('pk') on one H100, for any checkout of this repository.

    python3 chip_profile.py [--root DIR] [--repeat K]

DIR is a checkout (default: the one holding this script); its
agdiff_torch and chip_smoke.py are imported, so the same script reads an
older checkout unpacked beside this one (git archive), and two checkouts
read in one call compare on one card. Each path is profiled K times
(default 1) with DIR's chip_smoke.profile_slice, as its phase 6 does: 20
ladder steps of one chunk of 128 conformers of the first QM9 fixture
molecule in bucket 32, at the full width of configs/qm9_default.yml (A)
or qm9_fast.yml (B, D), seeded random weights. Prints the device busy
time, the idle share and the hand kernels' time; the rows go to
chiprun_out/chip_profile.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from agdiff_torch.config import load_config
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.models.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; checkout {root}", flush=True)
    dev = torch.device("cuda")

    def model(name):
        cfg = load_config(os.path.join(root, "configs", name)).model
        return cfg, init_random(DualEncoderEpsNetwork(cfg),
                                cs.SEED).to(dev).eval()

    fcfg, fmodel = model("qm9_default.yml")
    qcfg, qmodel = model("qm9_fast.yml")
    paths = {
        "path_A": (build_fast_forward(fcfg, fmodel, "pallas"),
                   {"K3": "block_agg_kernel", "K5": "gine_kernel"}),
        "path_B": (build_fast_forward(qcfg, qmodel, "pallas"),
                   {"K3": "block_agg_kernel"}),
        "path_D": (build_fast_forward(qcfg, qmodel, "pk"),
                   {"K2": "packed_block_kernel"}),
    }
    diffusion = make_diffusion(fcfg)
    mol = load_fixture()[0]
    report = {"card": card, "root": root, "profiles": {}, "runs": []}
    for k in range(args.repeat):
        for label, (fwd, kernels) in paths.items():
            cs.profile_slice(fwd, diffusion, mol, 32, cs.CHUNK, label,
                             report, kernels)
            report["runs"].append(dict(run=k, label=label,
                                       **report["profiles"][label]))
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_profile.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
