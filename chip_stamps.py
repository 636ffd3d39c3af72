#!/usr/bin/env python3
"""Where a K2 or K3 block's cycles go, phase by phase, on one H100.

    python3 chip_stamps.py [--root DIR]

DIR is a checkout of this repository (default: the one holding this
script); its agdiff_torch and chip_smoke.py are imported, so the same
script reads an older checkout unpacked beside this one (git archive).

A stamped copy of DIR's csrc/fused.cu and csrc/block_packed.cu (and the
headers they include) is written to agdiff_torch/kernels/build/stamped/
(ignored by git) and built with kernels/build.py's flags: after every
`__syncthreads();` of those files, thread 0 of each block adds the
clock64() cycles since its previous stamp to that barrier's counter
(atomicAdd into a __device__ array); each kernel entry starts the clock.
A barrier closes the phase before it, so its counter holds the phase's
cycles, waits for the slowest warp included. The script then runs K3 and
K2 at bf16 once each on the inputs the engines 'pallas' and 'pk' give
them at the full width of configs/qm9_fast.yml, B=128, N=32 (as
chip_smoke.py's phase 3b does), with the unstamped and the stamped
library, and prints each barrier's source line, its mean cycles per
block and its share. Details go to chiprun_out/chip_stamps.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import sys

SOURCES = ("fused", "block_packed")
STAMP_MAX = 64
PRELUDE = r'''
// ---- stamps (chip_stamps.py) ----
__device__ unsigned long long stamp_cycles[%d];
__shared__ long long stamp_last;
#define STAMP(k) do { if (threadIdx.x == 0) { const long long t_ = clock64(); \
  if ((k) >= 0) atomicAdd(&stamp_cycles[(k) < 0 ? 0 : (k)], \
                          (unsigned long long)(t_ - stamp_last)); \
  stamp_last = t_; } } while (0)
extern "C" int stamp_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stamp_cycles, sizeof(stamp_cycles));
}
extern "C" int stamp_reset() {
  static unsigned long long zero[%d] = {};
  return (int)cudaMemcpyToSymbol(stamp_cycles, zero, sizeof(zero));
}
''' % (STAMP_MAX, STAMP_MAX)
ENTRY = re.compile(r"(extern __shared__ __align__\(16\) float smem\[\];)")


def stamp_sources(csrc: str, out: str) -> list:
    """Copies csrc/<name>.cu and the headers they include into `out`,
    with a stamp after every barrier; returns each stamp's
    (index, file, line, the code line before the barrier)."""
    os.makedirs(out, exist_ok=True)
    labels, k = [], 0
    files = sorted(f for f in os.listdir(csrc)
                   if f.endswith(".cuh") or f[:-3] in SOURCES)
    for name in files:
        with open(os.path.join(csrc, name)) as f:
            lines = f.read().split("\n")
        done = []
        for n, line in enumerate(lines):
            if line.strip() == "__syncthreads();":
                before = next((x.strip() for x in reversed(done)
                               if x.strip() and not x.strip().startswith(
                                   ("}", "//"))), "")
                labels.append((k, name, n + 1, before[:70]))
                line = line + f" STAMP({k});"
                k += 1
            elif ENTRY.search(line):
                line = ENTRY.sub(r"\1 STAMP(-1);", line)
            done.append(line)
        text = "\n".join(done)
        if name.endswith(".cuh"):   # the prelude, once per library
            text = text.replace("typedef __nv_bfloat16 bf16;",
                                "typedef __nv_bfloat16 bf16;\n" + PRELUDE, 1)
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    if k > STAMP_MAX:
        raise SystemExit(f"{k} barriers, more than {STAMP_MAX} counters")
    return labels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_stamps: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from agdiff_torch.config import load_config
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import build, fused
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.weights import init_random

    card = cs.card_line()
    print(f"card: {card}; checkout {root}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cfg = load_config(os.path.join(root, "configs", "qm9_fast.yml")).model
    model = init_random(DualEncoderEpsNetwork(cfg), cs.SEED).to(dev).eval()
    batch = cs.random_batch(load_fixture(), 32, cs.CHUNK, gen)
    # label: (module, wrapper, forward, launch variant)
    cases = {
        "K3": (fused, "interaction_block_aggregate",
               build_fast_forward(cfg, model, "pallas"), "block_agg:bf16"),
        "K2": (k2, "packed_block_aggregate",
               build_fast_forward(cfg, model, "pk"), "packed_block:bf16"),
    }
    inputs = {}
    for label, (mod, name, fwd, _) in cases.items():
        inputs[label] = cs.capture(fwd, batch, name)

    def run(label):
        mod, name, _, _ = cases[label]
        a, kw = inputs[label]
        return getattr(mod, name)(*a, **kw)

    plain_ms = {label: cs.cuda_time(lambda label=label: run(label))
                for label in cases}
    stamped = os.path.join(build.BUILD_DIR, "stamped")
    shutil.rmtree(stamped, ignore_errors=True)
    labels = stamp_sources(build.CSRC, os.path.join(stamped, "csrc"))
    build.CSRC, build.BUILD_DIR = (os.path.join(stamped, "csrc"),
                                   os.path.join(stamped, "lib"))
    build._loaded.clear()
    build.build_all(SOURCES)
    report = {"card": card, "root": root, "kernels": {}}
    for label, (mod, _, _, _) in cases.items():
        lib = build.load("fused" if mod is fused else "block_packed")
        lib.stamp_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        run(label)
        torch.cuda.synchronize()
        if lib.stamp_reset() != 0:
            raise SystemExit("stamp_reset failed")
        run(label)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * STAMP_MAX)()
        if lib.stamp_read(counts) != 0:
            raise SystemExit("stamp_read failed")
        stamped_ms = cs.cuda_time(lambda label=label: run(label))
        # the launch's grid; a checkout without last_launch runs a block
        # per graph (K2) or per node row (K3)
        launch = getattr(mod, "last_launch", {}).get(cases[label][3], {})
        e = inputs[label][0][0]
        blocks = launch.get("grid") or (
            e.shape[0] if mod is k2 else e.shape[0] * e.shape[1])
        total = sum(counts)
        rows = [dict(stamp=k, file=f, line=n, before=b,
                     cycles=counts[k] / blocks, share=counts[k] / total)
                for k, f, n, b in labels if counts[k]]
        report["kernels"][label] = dict(variant=cases[label][3],
                                        ms=plain_ms[label],
                                        stamped_ms=stamped_ms,
                                        blocks=blocks,
                                        cycles_per_block=total / blocks,
                                        phases=rows)
        print(f"{label} {cases[label][3]}: {plain_ms[label]:.3f} ms "
              f"unstamped, "
              f"{stamped_ms:.3f} ms stamped; {blocks} blocks, "
              f"{total / blocks:.0f} cycles a block", flush=True)
        for r in rows:
            print(f"  {r['share']:.3f}  {r['cycles']:10.0f}  "
                  f"{r['file']}:{r['line']}  after: {r['before']}",
                  flush=True)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_stamps.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
