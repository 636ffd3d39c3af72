#!/usr/bin/env python3
"""Device time of the engine paths A ('pallas' f32), B ('pallas' bf16), C
and C-bf16 ('pallas' with pack_pairs=False, f32 and bf16), D ('pk'), E and
E-drugs ('mono') on one H100, for any checkout of this repository.

    python3 chip_profile.py [--root DIR] [--repeat K] [--graph]
                            [--paths A,B,C,C-bf16,D,E,E-drugs,QM9,Drugs]

DIR is a checkout (default: the one holding this script); its
agdiff_torch and chip_smoke.py are imported, so the same script reads an
older checkout unpacked beside this one (git archive), and two checkouts
read in one call compare on one card. Each path is profiled K times
(default 1) with DIR's chip_smoke.profile_slice, as its phase 6 does: 20
ladder steps of one chunk of 128 conformers of the first QM9 fixture
molecule in bucket 32, at the full width of configs/qm9_default.yml (A,
C) or qm9_fast.yml (B, C-bf16, D, E), and (E-drugs) of 48 conformers of
the first Drugs fixture molecule in bucket 64 at drugs_fast.yml, seeded
random weights. The default set is A, B, D, E and E-drugs; C and C-bf16
are named with --paths, and so are QM9 ('pksf', K1 over the triu set,
configs/qm9_fast.yml) and Drugs ('tight-pksf', K1 over the first Drugs
molecule's tight list, drugs_fast.yml, 48 conformers in bucket 64). The
steps run eagerly, or with --graph as replays of the ladder's CUDA
graphs (sampling/graphed.py), captured outside the window; a graphed
row also holds the capture's seconds and each hand kernel's launches in
the window against those the replays ran. Prints the device busy time,
the idle share and the hand kernels' time; the rows go to
chiprun_out/chip_profile.json under the working directory
(chip_profile_<DIR's name>.json for another checkout).
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
    parser.add_argument("--paths", default="A,B,D,E,E-drugs")
    parser.add_argument("--graph", action="store_true",
                        help="replay the ladder as CUDA graphs")
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
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.models.tight_forward import build_tight_forward
    from agdiff_torch.models.weights import init_random
    from agdiff_torch.ops.pairs import pair_capacity_for

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
    dcfg, dmodel = model("drugs_fast.yml")
    qmol, dmol = load_fixture()[0], load_fixture("drugs_synthetic")[0]
    fdiff = make_diffusion(fcfg)
    k6 = {"K6": "mono_kernel"}
    k1 = {"K1": "stack_kernel"}
    # label: forward, hand kernels, diffusion, molecule, bucket, chunk
    # (and the pair capacity of a tight forward)
    paths = {
        "QM9": lambda: (build_fast_forward(qcfg, qmodel, "pksf"), k1,
                        make_diffusion(qcfg), qmol, 32, cs.CHUNK),
        "Drugs": lambda: (build_tight_forward(dcfg, dmodel, "tight-pksf"),
                          k1, make_diffusion(dcfg), dmol, 64,
                          cs.DRUGS_CHUNK,
                          pair_capacity_for(dmol.num_nodes, 256)),
        "A": lambda: (build_fast_forward(fcfg, fmodel, "pallas"),
                      {"K3": "block_agg_kernel", "K5": "gine_kernel"},
                      fdiff, qmol, 32, cs.CHUNK),
        "B": lambda: (build_fast_forward(qcfg, qmodel, "pallas"),
                      {"K3": "block_agg_kernel"}, fdiff, qmol, 32, cs.CHUNK),
        "C": lambda: (build_fast_forward(fcfg, fmodel, "pallas",
                                         pack_pairs=False),
                      {"K3": "block_agg_kernel", "K5": "gine_kernel",
                       "K4": "pair_score_kernel"}, fdiff, qmol, 32, cs.CHUNK),
        "C-bf16": lambda: (build_fast_forward(qcfg, qmodel, "pallas",
                                              pack_pairs=False),
                           {"K3": "block_agg_kernel",
                            "K4": "pair_score_kernel"}, fdiff, qmol, 32,
                           cs.CHUNK),
        "D": lambda: (build_fast_forward(qcfg, qmodel, "pk"),
                      {"K2": "packed_block_kernel"}, fdiff, qmol, 32,
                      cs.CHUNK),
        "E": lambda: (build_monolithic_forward(qcfg, qmodel), k6, fdiff,
                      qmol, 32, cs.CHUNK),
        "E-drugs": lambda: (build_monolithic_forward(dcfg, dmodel), k6,
                            make_diffusion(dcfg), dmol, 64, cs.DRUGS_CHUNK),
    }
    chosen = {p: paths[p]() for p in args.paths.split(",")}
    report = {"card": card, "root": root, "profiles": {}, "runs": []}
    for k in range(args.repeat):
        for p, (fwd, kernels, diff, mol, bucket, chunk, *cap) in \
                chosen.items():
            label = ("graph_" if args.graph else "") + "path_" + p
            cs.profile_slice(fwd, diff, mol, bucket, chunk, label, report,
                             kernels, capacity=cap[0] if cap else None,
                             graph=args.graph)
            report["runs"].append(dict(run=k, label=label,
                                       **report["profiles"][label]))
    here = os.path.dirname(os.path.abspath(__file__))
    name = "chip_profile" + ("" if root == here
                             else "_" + os.path.basename(root)) + ".json"
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
