#!/usr/bin/env python3
"""Where a K2, K3, K4 or K6 block's cycles go, phase by phase, on one
H100, and whether two checkouts' kernels give the same bits.

    python3 chip_stamps.py [--root DIR] [--save FILE] [--compare FILE]

DIR is a checkout of this repository (default: the one holding this
script); its agdiff_torch and chip_smoke.py are imported, so the same
script reads an older checkout unpacked beside this one (git archive).

A stamped copy of DIR's csrc/fused.cu, csrc/block_packed.cu and
csrc/mono.cu (and the headers they include) is written to
agdiff_torch/kernels/build/stamped/ (ignored by git) and built with
kernels/build.py's flags: after every `__syncthreads();` of those files,
thread 0 of each block adds the clock64() cycles since its previous stamp
to that barrier's counter (atomicAdd into a __device__ array, under the
block's current phase); each kernel entry starts the clock. A barrier
closes the phase before it, so its counter holds the phase's cycles,
waits for the slowest warp included. The phase is set at the comments
that open each part (PHASES): in mono.cu the encoder, the SchNet node
side (node input and tail), the SchNet pair loop, GIN and the heads, so
that a product() barrier, which every part shares, is counted by part; in
fused.cu K4's weight staging and mask scan, zero fill, tile load with the
product, first layer, and second layer with the head. The script runs, on
the inputs chip_smoke.py gives them:
  * K3 and K2 at bf16, K3 and K2 at f32 (K2's on path D's inputs taken at
    f32) and K4 at f32 and bf16 (the global head's first call,
    pack_pairs=False) on the inputs the engines 'pallas' and 'pk' give
    them at the full width of configs/qm9_fast.yml (qm9_default.yml for
    f32), B=128, N=32 (phase 3b);
  * K6 in chip_smoke.py's four phase-5b cases (bf16 and f32, QM9
    B=128/N=32 and Drugs B=48/N=64, positions spread MONO_POS_SCALE),
    each from a generator seeded by the case, so both checkouts get the
    same inputs;
each once with the unstamped library (timed) and once stamped, and prints
each (phase, barrier)'s source line, its mean cycles per block and its
share. Unstamped only (timed, outputs saved and compared, no stamped copy
of their sources):
  * K1 (csrc/stack_packed.cu) in chip_smoke.py's phase-3 variants: mode
    'full' over the triu set at B=128/N=32 (configs/qm9_fast.yml), and
    over the 50-atom Drugs molecule's tight list at B=48/N=64
    (drugs_fast.yml) in modes 'full', 'schnet', 'gin' and 'full' with
    '-approx', each from a generator seeded by the case;
  * K5 (f32, path A's inputs) and K2 '-approx' (path D''s inputs). --save writes every case's unstamped outputs (and a checksum of
its inputs) to FILE; --compare reads such a file, from another checkout,
and prints for each case whether the outputs are torch.equal (and the
largest difference), the parent-equality check of a kernel redesign that
keeps its arithmetic. Details go to chiprun_out/chip_stamps.json under
the working directory (chip_stamps_<DIR's name>.json for another
checkout).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import sys

SOURCES = ("fused", "block_packed", "mono")
STAMP_MAX = 128
# the parts of a kernel: (file, comment that opens it, phase); phase 0 is
# the prologue
PHASES = (("mono.cu", r"// ---- 1\. ", 1), ("mono.cu", r"// node input x", 2),
          ("mono.cu", r"// the distance weight times the envelope", 3),
          ("mono.cu", r"// node tail", 2), ("mono.cu", r"// ---- 3\. ", 4),
          ("mono.cu", r"// ---- 4\. ", 5),
          ("fused.cu", r"// K4: stage and scan the mask", 6),
          ("fused.cu", r"// K4: zero fill", 7),
          ("fused.cu", r"// K4: tile load with the product", 8),
          ("fused.cu", r"// K4: layer 1", 9),
          ("fused.cu", r"// K4: layer 2 and the head", 10))
PHASE_NAMES = ("prologue", "encoder", "schnet_node", "schnet_pairs", "gin",
               "heads", "k4_stage_scan", "k4_zero_fill", "k4_tile_load",
               "k4_layer1", "k4_layer2_head")
PRELUDE = r'''// ---- stamps (chip_stamps.py) ----
#pragma once
#include <cuda_runtime.h>
#define STAMP_MAX %d
#define STAMP_PHASES %d
#define STAMP_BLOCKS 8192
__device__ unsigned long long stamp_cycles[STAMP_PHASES * STAMP_MAX];
__device__ long long stamp_last[STAMP_BLOCKS];
__device__ int stamp_phase[STAMP_BLOCKS];
#define STAMP_SLOT (blockIdx.x %% STAMP_BLOCKS)
#define STAMP(k) do { if (threadIdx.x == 0) { const long long t_ = clock64(); \
  atomicAdd(&stamp_cycles[stamp_phase[STAMP_SLOT] * STAMP_MAX + (k)], \
            (unsigned long long)(t_ - stamp_last[STAMP_SLOT])); \
  stamp_last[STAMP_SLOT] = t_; } } while (0)
#define STAMP_ENTRY() do { if (threadIdx.x == 0) { \
  stamp_phase[STAMP_SLOT] = 0; stamp_last[STAMP_SLOT] = clock64(); } } \
  while (0)
#define STAMP_PHASE(p) do { if (threadIdx.x == 0) \
  stamp_phase[STAMP_SLOT] = (p); } while (0)
static inline int stamp_read_(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, stamp_cycles, sizeof(stamp_cycles));
}
static inline int stamp_reset_() {
  static unsigned long long zero[STAMP_PHASES * STAMP_MAX] = {};
  return (int)cudaMemcpyToSymbol(stamp_cycles, zero, sizeof(zero));
}
''' % (STAMP_MAX, len(PHASE_NAMES))
# the exported readers, once per library (in its .cu file)
EXPORTS = r'''
extern "C" int stamp_read(unsigned long long* out) { return stamp_read_(out); }
extern "C" int stamp_reset() { return stamp_reset_(); }
'''
ENTRY = re.compile(r"(extern __shared__ __align__\(\d+\) [\w ]+ smem\[\];)")


def stamp_sources(csrc: str, out: str) -> list:
    """Copies csrc/<name>.cu and the headers they include into `out`,
    with a stamp after every barrier and a phase mark after each of
    PHASES' comments; returns each stamp's (index, file, line, the code
    line before the barrier)."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "stamps.cuh"), "w") as f:
        f.write(PRELUDE)
    labels, k = [], 0
    files = sorted(f for f in os.listdir(csrc)
                   if f.endswith(".cuh") or f[:-3] in SOURCES)
    for name in files:
        with open(os.path.join(csrc, name)) as f:
            lines = f.read().split("\n")
        done = ['#include "stamps.cuh"']
        for n, line in enumerate(lines):
            if line.strip() == "__syncthreads();":
                before = next((x.strip() for x in reversed(done)
                               if x.strip() and not x.strip().startswith(
                                   ("}", "//", "STAMP"))), "")
                labels.append((k, name, n + 1, before[:70]))
                line = line + f" STAMP({k});"
                k += 1
            elif ENTRY.search(line):
                line = ENTRY.sub(r"\1 STAMP_ENTRY();", line)
            done.append(line)
            for where, pattern, phase in PHASES:
                if name == where and re.match(r"\s*" + pattern, line):
                    done.append(f"STAMP_PHASE({phase});")
        if name.endswith(".cu"):
            done.append(EXPORTS)
        with open(os.path.join(out, name), "w") as f:
            f.write("\n".join(done))
    if k > STAMP_MAX:
        raise SystemExit(f"{k} barriers, more than {STAMP_MAX} counters")
    return labels


def mono_cases(cs, root, dev):
    """chip_smoke.py's phase-5b K6 inputs: label -> kernel_inputs."""
    import torch

    from agdiff_torch.config import load_config
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.models.weights import init_random

    def cfg_of(name):
        return load_config(os.path.join(root, "configs", name)).model

    qmols, dmols = load_fixture(), load_fixture("drugs_synthetic")
    drugs = cfg_of("drugs_fast.yml")
    out = {}
    for k, (label, cfg, mols, n, b) in enumerate((
            ("K6 bf16_B128_N32", cfg_of("qm9_fast.yml"), qmols, 32, 128),
            ("K6 bf16_B48_N64", drugs, dmols[:1], 64, 48),
            ("K6 f32_B128_N32", cfg_of("qm9_default.yml"), qmols, 32, 128),
            ("K6 f32_B48_N64", dataclasses.replace(drugs, dtype="float32"),
             dmols[:1], 64, 48))):
        model = init_random(DualEncoderEpsNetwork(cfg), cs.SEED).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + k)
        batch = cs.random_batch(mols, n, b, gen)
        batch = batch.replace(pos=batch.pos * cs.MONO_POS_SCALE)
        out[label] = build_monolithic_forward(cfg, model.eval()) \
            .kernel_inputs(batch)[0]
    return out


def k1_cases(cs, root, dev):
    """chip_smoke.py's phase-3 K1 variants: label -> keyword arguments of
    kernels/stack_packed.packed_stack_forward."""
    import torch

    from agdiff_torch.config import load_config
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.tight_forward import build_tight_forward
    from agdiff_torch.ops.pairs import pair_capacity_for
    from agdiff_torch.models.weights import init_random

    def model_of(name):
        cfg = load_config(os.path.join(root, "configs", name)).model
        return cfg, init_random(DualEncoderEpsNetwork(cfg),
                                cs.SEED).to(dev).eval()

    qcfg, qmodel = model_of("qm9_fast.yml")
    dcfg, dmodel = model_of("drugs_fast.yml")
    mol = load_fixture("drugs_synthetic")[0]
    out = {}
    for k, (label, engine) in enumerate((
            ("K1 triu_B128_N32", "pksf"), ("K1 tight_B48_N64", "tight-pksf"),
            ("K1 schnet_B48_N64", "tight-pks"),
            ("K1 gin_B48_N64", "tight-pksg"),
            ("K1 full_approx_B48_N64", "tight-pksf-approx"))):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10 + k)
        if engine == "pksf":
            fwd = build_fast_forward(qcfg, qmodel, engine)
            kw, _ = fwd.stack_inputs(cs.random_batch(load_fixture(), 32,
                                                     cs.CHUNK, gen))
        else:
            fwd = build_tight_forward(dcfg, dmodel, engine)
            batch = cs.random_batch([mol], 64, cs.DRUGS_CHUNK, gen)
            kw, _ = fwd.stack_inputs(batch, fwd.prepare(
                batch, pair_capacity_for(mol.num_nodes, 256)))
        out[label] = dict(kw, mode=fwd.mode, approx=fwd.approx)
    return out


def bits(t):
    """A float tensor's bit patterns, as integers of its width."""
    import torch

    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def checksum(args) -> float:
    import torch

    ts = [t for t in (args.values() if isinstance(args, dict) else args)
          if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return float(sum(t.double().abs().sum() for t in ts))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--save", help="write the unstamped outputs here")
    parser.add_argument("--compare", help="outputs of another checkout")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_stamps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from agdiff_torch.config import load_config
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import build, fused
    from agdiff_torch.kernels import monolithic as k6
    from agdiff_torch.kernels import stack_packed as k1
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.weights import init_random

    card = cs.card_line()
    print(f"card: {card}; checkout {root}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def model_of(name):
        cfg = load_config(os.path.join(root, "configs", name)).model
        return cfg, init_random(DualEncoderEpsNetwork(cfg),
                                cs.SEED).to(dev).eval()

    qcfg, qmodel = model_of("qm9_fast.yml")
    fcfg, fmodel = model_of("qm9_default.yml")
    batch = cs.random_batch(load_fixture(), 32, cs.CHUNK, gen)
    # label: (module, wrapper, launch variant, library), inputs (args, kw)
    cases, inputs = {}, {}
    for label, mod, name, fwd, var in (
            ("K3 bf16", fused, "interaction_block_aggregate",
             build_fast_forward(qcfg, qmodel, "pallas"), "block_agg:bf16"),
            ("K2 bf16", k2, "packed_block_aggregate",
             build_fast_forward(qcfg, qmodel, "pk"), "packed_block:bf16"),
            ("K3 f32", fused, "interaction_block_aggregate",
             build_fast_forward(fcfg, fmodel, "pallas"), "block_agg:f32"),
            ("K4 f32", fused, "pair_score_mlp",
             build_fast_forward(fcfg, fmodel, "pallas", pack_pairs=False),
             "pair_score:f32"),
            ("K4 bf16", fused, "pair_score_mlp",
             build_fast_forward(qcfg, qmodel, "pallas", pack_pairs=False),
             "pair_score:bf16")):
        cases[label] = (mod, name, var, "fused" if mod is fused
                        else "block_packed")
        inputs[label] = cs.capture(fwd, batch, name)
    # K2's f32 variant (no engine runs it) on path D's inputs at f32
    a, kw = inputs["K2 bf16"]
    cases["K2 f32"] = (k2, "packed_block_aggregate", "packed_block:f32",
                       "block_packed")
    inputs["K2 f32"] = ([x.float() if isinstance(x, torch.Tensor) else x
                         for x in a], kw)
    for label, kw in mono_cases(cs, root, dev).items():
        cases[label] = (k6, "mono_forward", None, "mono")
        inputs[label] = ((), kw)
    # compared and timed, not stamped
    unstamped = {"K5 f32", "K2 bf16-approx"}
    for label, mod, name, fwd, var in (
            ("K5 f32", fused, "gine_aggregate",
             build_fast_forward(fcfg, fmodel, "pallas"), "gine:f32"),
            ("K2 bf16-approx", k2, "packed_block_aggregate",
             build_fast_forward(qcfg, qmodel, "pk-approx"),
             "packed_block_approx:bf16")):
        cases[label] = (mod, name, var, None)
        inputs[label] = cs.capture(fwd, batch, name)
    for label, kw in k1_cases(cs, root, dev).items():
        cases[label] = (k1, "packed_stack_forward", None, None)
        inputs[label] = ((), kw)
        unstamped.add(label)

    def run(label):
        mod, name, _, _ = cases[label]
        a, kw = inputs[label]
        out = getattr(mod, name)(*a, **kw)
        return (out,) if isinstance(out, torch.Tensor) else out

    build.build_all(SOURCES + ("stack_packed",))
    outputs, plain_ms = {}, {}
    for label in cases:
        outputs[label] = tuple(t.cpu() for t in run(label))
        plain_ms[label] = cs.cuda_time(lambda label=label: run(label))
    report = {"card": card, "root": root, "kernels": {}, "compare": {}}
    sums = {label: checksum(inputs[label][0] or inputs[label][1])
            for label in cases}
    if args.save:
        torch.save({"outputs": outputs, "checksums": sums}, args.save)
    if args.compare:
        other = torch.load(args.compare)
        for label, outs in outputs.items():
            if label not in other["outputs"]:
                continue
            ref = other["outputs"][label]
            same = all(torch.equal(a, b) for a, b in zip(outs, ref))
            diff = max(float((a - b).abs().max()) for a, b in zip(outs, ref))
            # torch.equal takes -0.0 for 0.0: count the zeros whose sign
            # moved, the one difference a NaN-keeping max may make
            signs = sum(int(((a == b) & (bits(a) != bits(b))).sum())
                        for a, b in zip(outs, ref))
            row = dict(equal=same, max_abs_diff=diff, zero_signs=signs,
                       same_inputs=sums[label] == other["checksums"][label])
            report["compare"][label] = row
            print(f"{label}: torch.equal to {args.compare}: {same} (max "
                  f"|diff| {diff:.3e}; zeros of the other sign {signs}; "
                  f"same inputs {row['same_inputs']})", flush=True)
    for label in sorted(unstamped):
        report["kernels"][label] = dict(variant=cases[label][2] or label,
                                        ms=plain_ms[label])
        print(f"{label}: {plain_ms[label]:.3f} ms unstamped", flush=True)
    stamped = os.path.join(build.BUILD_DIR, "stamped")
    shutil.rmtree(stamped, ignore_errors=True)
    labels = stamp_sources(build.CSRC, os.path.join(stamped, "csrc"))
    build.CSRC, build.BUILD_DIR = (os.path.join(stamped, "csrc"),
                                   os.path.join(stamped, "lib"))
    build._loaded.clear()
    build.build_all(SOURCES)
    n_ph = len(PHASE_NAMES)
    for label, (mod, _, var, libname) in cases.items():
        if label in unstamped:
            continue
        lib = build.load(libname)
        lib.stamp_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        run(label)
        torch.cuda.synchronize()
        if lib.stamp_reset() != 0:
            raise SystemExit("stamp_reset failed")
        run(label)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * (n_ph * STAMP_MAX))()
        if lib.stamp_read(counts) != 0:
            raise SystemExit("stamp_read failed")
        stamped_ms = cs.cuda_time(lambda label=label: run(label))
        # the launch's grid; a checkout without last_launch runs a block
        # per graph (K2, K6) or per node row (K3, K4)
        a, kw = inputs[label]
        if mod is k6:
            blocks = kw["dp"].shape[0]
        else:
            launch = getattr(mod, "last_launch", {}).get(var, {})
            blocks = launch.get("grid") or (
                a[0].shape[0] if mod is k2 else a[0].shape[0] * a[0].shape[1])
        total = sum(counts)
        rows = [dict(phase=PHASE_NAMES[ph], stamp=k, file=f, line=n,
                     before=b, cycles=counts[ph * STAMP_MAX + k] / blocks,
                     share=counts[ph * STAMP_MAX + k] / total)
                for ph in range(n_ph) for k, f, n, b in labels
                if counts[ph * STAMP_MAX + k]]
        phases = {}
        for r in rows:
            phases[r["phase"]] = phases.get(r["phase"], 0.0) + r["share"]
        report["kernels"][label] = dict(variant=var or label,
                                        ms=plain_ms[label],
                                        stamped_ms=stamped_ms,
                                        blocks=blocks,
                                        cycles_per_block=total / blocks,
                                        phase_shares=phases, rows=rows)
        print(f"{label}: {plain_ms[label]:.3f} ms unstamped, "
              f"{stamped_ms:.3f} ms stamped; {blocks} blocks, "
              f"{total / blocks:.0f} cycles a block", flush=True)
        if len(phases) > 1:
            print("  by phase: " + ", ".join(
                f"{p} {s:.3f}" for p, s in phases.items()), flush=True)
        for r in rows:
            print(f"  {r['share']:.3f}  {r['cycles']:10.0f}  "
                  f"{r['phase'] + '  ' if len(phases) > 1 else ''}"
                  f"{r['file']}:{r['line']}  after: {r['before']}",
                  flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    name = "chip_stamps" + ("" if root == here
                            else "_" + os.path.basename(root)) + ".json"
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
