#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (agdiff_torch) on one H100.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. a CUDA card of compute capability 9.0 is required; its name and power
     limit are printed as nvidia-smi reports them;
  2. the CUDA source agdiff_torch/kernels/csrc/stack_packed.cu is built
     with nvcc;
  3. K1 (the whole-stack kernel) is held against its plain PyTorch version
     on the card, on the inputs the main paths give it, output by output
     (each score plane, or h and hl over real nodes, on its own scale),
     and planted faults in the plain version must break the same limits;
     the plain version on the CPU is read against the one on the card for
     scale; every case is timed beside its bound:
     - over the triu pair set at the full width of configs/qm9_fast.yml
       (H=128, six SchNet blocks, four GIN layers, bf16), mode 'full', at
       B=128/N=32 and B=48/N=64;
     - over tight pair lists at the full width of configs/drugs_fast.yml,
       B=48: mode 'full' at N=64, 80, 96 and 128 (node temporaries in
       global memory from N=48, node states too from N=96), and modes
       'schnet', 'gin' and 'full' with '-approx' at N=64;
     - at N=64 and N=96 also at every layout level that fits, each of
       which must give the bits of the wrapper's choice;
  4. the QM9 slice: GenerationRunner generates conformers for the
     molecules of agdiff_torch/data/fixtures/qm9_synthetic.json on the
     'pksf' engine (bucket 32, chunk 128, w_global 0.3, a 500-step suffix
     of the 5000-step ladder) with seeded random weights; a small batch is
     also checked against the f32 plain engine;
  5. the Drugs slice: GenerationRunner on configs/drugs_fast.yml runs the
     molecules of agdiff_torch/data/fixtures/drugs_synthetic.json (50 and
     56 atoms in bucket 64, 69 and 73 atoms above it) on 'tight-pksf'
     (chunk 48, w_global 0.3, 500 steps), and the engines 'tight-pks',
     'tight-pksg' and 'tight-pksf-approx' for a few steps each; a small
     batch is checked against the f32 'tight' engine, beside the same
     check with K1's plain version on the CPU;
     in every slice and engine run, K1's launches of the path's variant
     must equal the forwards run, counted from 0 just before it, and
     every position must be finite;
  6. where the time goes: torch.profiler over a few ladder steps of one
     chunk of each slice gives K1's share of the device time, the
     device's idle share and the largest kernels;
  7. one JSON line lists each kernel variant and its numbers, then the
     card's line, then the last line {"ok": true, "device": {...}}.
Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 0
N_STEPS = 500
CHUNK = 128             # QM9 slice
DRUGS_CHUNK = 48        # Drugs slice
VARIANT_STEPS = 20      # ladder steps of each further engine
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s (data sheet)
# K1 against its plain version, on each output, as shares of that
# output's max |plain value| (tests/test_torch_port_cuda.py holds the
# same): f32 sums in another order flip single bf16 roundings, which later
# layers carry on. Each limit lies between the kernel's readings and those
# of the planted faults (planted_faults, PERF.md).
K1_LIMITS = dict(max_rel=0.03, median_rel=1e-6, p99_rel=3e-3,
                 beyond_1pct=1e-3)
# The Drugs cases, per output. At Drugs size every atom exchanges
# messages with ~50 others within the cutoff, so one bf16 rounding that a
# last-bit difference flips reaches every atom of its graph within a
# SchNet block: on the global branch (h and its plane) the plain version
# on the CPU, whose softplus and sigmoid differ from CUDA's in the last
# bits, differs from the one on the card as much as the kernel does
# (check_k1 reads both, PERF.md). On the local branch the two plain
# versions agree to 2e-6, and the kernel, whose products sum in another
# order, flips a few bf16 roundings of hl (one bf16 unit is 2 at |hl| ~
# 330): max up to 8e-2, median 5e-8. The median separates the
# kernel from every planted fault (by 3x on the global branch, by 1000x
# on the local one); max, p99 and the share beyond 1% sit above the
# kernel's flips and catch gross faults.
DRUGS_LIMITS = {
    "global": dict(max_rel=0.03, median_rel=8e-4, p99_rel=6e-3,
                   beyond_1pct=1e-3),
    "local": dict(max_rel=0.12, median_rel=1e-6, p99_rel=3e-2,
                  beyond_1pct=3e-2),
    "h": dict(max_rel=5e-4, median_rel=2e-5, p99_rel=1e-4,
              beyond_1pct=1e-3),
    "hl": dict(max_rel=1e-2, median_rel=1e-6, p99_rel=3e-3,
               beyond_1pct=1e-3),
}
QM9_LIMITS = {"global": K1_LIMITS, "local": K1_LIMITS}
ENGINE_TOL = 0.05       # bf16 engine vs f32 engine, the JAX slim gate's
# At Drugs size with random weights the local scores reach ~150 after four
# GIN layers, and bf16 arithmetic itself reads ~0.11 of the largest against
# f32 there: phase 5 reads the same engine with K1's plain version on the
# CPU beside the kernel's reading, under the same limit
DRUGS_ENGINE_TOL = 0.15
PROFILE_STEPS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int = 20) -> float:
    """Median ms of `reps` timed calls (CUDA events), after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_work(kw, mode: str) -> tuple:
    """(FLOPs, bytes) K1 must do on these inputs in `mode`: every product
    at 2 FLOPs per multiply-add plus the aggregation sums, the SchNet and
    GIN work over the list's valid pairs (pad slots carry nothing), the
    heads over every slot; each input read once and each output written
    once."""
    e, we, h0 = kw["e_packed"], kw["we"], kw["h0"]
    prm, pairs = kw["params"], kw["pairs"]
    b, p, c = e.shape
    v = pairs.num_valid
    n, h = h0.shape[1], h0.shape[2]
    nb, nl = len(prm.blocks), len(prm.gin_layers)
    f1, f2, r = h, h // 2, h // 16
    fw = f1 + f2
    block = (2 * v * (c * fw + f1 * f1 + f2 * f2)        # filter MLPs
             + 2 * v * fw * 2                            # messages, sums
             + 2 * n * (h * fw + f1 * h + f2 * h + 2 * h * h
                        + h * h // 2 + h // 2 + 2 * h * r))
    gin = 2 * n * h * h * 2 + 2 * v * h * 3
    head = 2 * p * (h * h + c * h + h * h // 2 + h // 2) + p * h
    flops = b * nb * block
    ins = [e, we, h0, pairs.iu, pairs.ju, pairs.inc_ptr, pairs.inc]
    if mode != "schnet":
        flops += b * nl * gin
        ins += [kw["hl0"], kw["local_mask_p"].float()]
        if kw["e_packed_local"].data_ptr() != e.data_ptr():
            ins.append(kw["e_packed_local"])
    if mode == "full":
        flops += b * 2 * head
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    nbytes += sum(t.numel() * t.element_size() for t in prm._packed[
        e.device])
    nbytes += {"full": 2 * b * p, "gin": 2 * b * n * h,
               "schnet": b * n * h}[mode] * 4
    return flops, nbytes


def errors(got, ref, mask=None) -> dict:
    """|got - plain| over the entries `mask` selects, as shares of the
    max |plain value| there: max, median, p99, and the share of entries
    off by more than 1% of it."""
    import torch

    if mask is not None:
        got, ref = got[mask], ref[mask]
    scale = float(ref.abs().max())
    d = (got - ref).abs().flatten() / scale
    return dict(
        max_abs_value=scale, max_abs_err=float(d.max()) * scale,
        max_rel=float(d.max()), median_rel=float(d.median()),
        p99_rel=float(d.kthvalue(max(1, int(0.99 * d.numel()))).values),
        beyond_1pct=float((d > 0.01).float().mean()),
        finite=bool(torch.isfinite(got).all()))


def output_errors(got, ref, mode, node_mask) -> dict:
    """Per output of the mode: the two score planes (every slot), or h
    (and hl) over real nodes."""
    names = {"full": ("global", "local"), "gin": ("h", "hl"),
             "schnet": ("h",)}[mode]
    if mode == "schnet":
        got, ref = (got,), (ref,)
    mask = None if mode == "full" else node_mask
    return {name: errors(g, r, mask) for name, g, r in zip(names, got, ref)}


def broken_limits(rows, limits) -> list:
    """The (output, statistic) pairs that break their limits."""
    return [(name, k) for name, row in rows.items()
            for k, lim in limits[name].items()
            if not (row["finite"] and row[k] <= lim)]


def planted_faults(kw, ref, mode, approx):
    """Wrong versions of K1's function, each the plain version with one
    planted fault, to show the gate fails them: (name, outputs)."""
    import dataclasses

    import torch

    from agdiff_torch.kernels import stack_packed as k1

    prm = kw["params"]

    def plain(**over):
        return k1.packed_stack_forward_plain(
            **dict(kw, **over), mode=mode, approx=approx)

    def no_bias(layers, key):
        w, bias = layers[-1][key]
        return layers[:-1] + [dict(layers[-1], **{key: (
            w, torch.zeros_like(bias))})]

    yield "no bf16 rounding (f32 plain)", plain(
        e_packed=kw["e_packed"].float(),
        e_packed_local=kw["e_packed_local"].float())
    yield "last SchNet block: lin bias dropped", plain(
        params=dataclasses.replace(prm, blocks=no_bias(prm.blocks, "lin"),
                                   _packed={}))
    if mode != "schnet":
        yield "last GIN layer: l1 bias dropped", plain(
            params=dataclasses.replace(
                prm, gin_layers=no_bias(prm.gin_layers, "l1"), _packed={}))
    if mode == "full":
        yield "global plane zeroed", (torch.zeros_like(ref[0]), ref[1])


def check_k1(kw, node_mask, label, mode, approx, limits, cpu_params,
             report) -> tuple:
    """K1 against its plain version on a main path's inputs, output by
    output; also the planted faults against the same limits, and, for
    scale, the plain version on the CPU (`cpu_params`: the same weights
    there) against the plain version on the card: how far last-bit
    differences of the same function (each device's exp and log, its
    summation order) carry at this size. Returns the case's row and its
    failures."""
    import torch

    from agdiff_torch.kernels import stack_packed as k1

    def kernel():
        return k1.packed_stack_forward(**kw, mode=mode, approx=approx)

    def plain():
        return k1.packed_stack_forward_plain(**kw, mode=mode, approx=approx)

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    outs = output_errors(got, ref, mode, node_mask)
    flat = (lambda x: (x,)) if mode == "schnet" else tuple
    repro = all(torch.equal(g, a) for g, a in zip(flat(got), flat(again)))
    faults = {name: output_errors(out, ref, mode, node_mask)
              for name, out in planted_faults(kw, ref, mode, approx)}
    ms = cuda_time(kernel)
    plain_ms = cuda_time(plain)
    # after the timings, which a busy host would disturb
    on_cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
    on_cpu.update(params=cpu_params, pairs=kw["pairs"].to("cpu"))
    plain_cpu = k1.packed_stack_forward_plain(**on_cpu, mode=mode,
                                              approx=approx)
    cross = output_errors(
        plain_cpu.cuda() if mode == "schnet"
        else tuple(t.cuda() for t in plain_cpu), ref, mode, node_mask)
    flops, nbytes = k1_work(kw, mode)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    b, p = kw["we"].shape[1:]
    n = kw["h0"].shape[1]
    pairs = kw["pairs"]
    row = dict(case=label, mode=mode, approx=approx,
               variant=k1.variant(mode, approx, pairs.tight), B=b, N=n, P=p,
               valid_pairs=pairs.num_valid,
               layout_level=k1.layout(n, kw["h0"].shape[2])[0],
               outputs=outs, limits={k: limits[k] for k in outs},
               planted_faults=faults, plain_cpu_vs_plain=cross,
               bitwise_reproducible=repro,
               max_abs_err=max(r["max_abs_err"] for r in outs.values()),
               ms=ms, plain_ms=plain_ms, flops=flops, bytes=nbytes,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    report["k1_checks"].append(row)

    def line(rows):
        return "; ".join(
            f"{name}: max {r['max_rel']:.3e} median {r['median_rel']:.3e} "
            f"p99 {r['p99_rel']:.3e} beyond-1% {r['beyond_1pct']:.3e} "
            f"(max|value| {r['max_abs_value']:.3e})"
            for name, r in rows.items())

    print(f"K1 {label} [{row['variant']}, layout {row['layout_level']}]: "
          f"B={b} N={n} P={p} valid {pairs.num_valid}; |kernel - plain| as "
          f"shares of each output's max|value|: {line(outs)}; two launches "
          f"bitwise equal {repro}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    print(f"  plain version on the CPU vs on the card: {line(cross)}",
          flush=True)
    failures = [f"K1 {label}: kernel breaks {name} {k}"
                for name, k in broken_limits(outs, limits)]
    if not repro:
        failures.append(f"K1 {label}: two launches differ")
    for name, rows in faults.items():
        caught = broken_limits(rows, limits)
        print(f"  planted fault '{name}': {line(rows)}; caught by "
              f"{caught}", flush=True)
        if not caught:
            failures.append(f"K1 {label}: the gate passes the planted fault "
                            f"'{name}'")
    return row, failures


def check_levels(kw, label, report) -> list:
    """K1 at every layout level that fits these inputs (node regions in
    shared memory, node temporaries in global scratch, all node regions
    in global scratch): each must give the bits of the wrapper's choice;
    each is timed."""
    import torch

    from agdiff_torch.kernels import stack_packed as k1

    n, h = kw["h0"].shape[1:]
    chosen = k1.layout(n, h)[0]
    ref = k1.packed_stack_forward(**kw)
    rows, failures = [], []
    for level in (0, 1, 2):
        if k1.smem_bytes(n, h, level) > k1.MAX_SMEM:
            continue
        out = k1.packed_stack_forward(**kw, level=level)
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        ms = cuda_time(lambda: k1.packed_stack_forward(**kw, level=level))
        staged = (-(-k1.smem_bytes(n, h, level) // 128) * 128
                  + k1.weight_region_bytes(h) <= k1.MAX_SMEM)
        rows.append(dict(level=level, chosen=level == chosen,
                         weights_staged=staged, ms=ms, same_bits=same))
        print(f"K1 {label} at layout level {level} (weights staged "
              f"{staged}{', chosen' if level == chosen else ''}): {ms:.3f} "
              f"ms, same bits as the chosen level: {same}", flush=True)
        if not same:
            failures.append(f"K1 {label}: level {level} differs")
    report["levels"][label] = rows
    return failures


def random_batch(mol, n, b, gen):
    """`mol` repeated b times in a bucket of n, at random positions."""
    import torch

    from agdiff_torch.data.bucketing import pad_molecules

    batch = pad_molecules([mol] * b, n, device=gen.device)
    return batch.replace(pos=torch.randn(
        batch.pos.shape, generator=gen, device=gen.device)
        * batch.node_mask[..., None])


def union(m1, m2):
    """One graph of two molecules, the second shifted 6 A along x."""
    import numpy as np

    from agdiff_torch.chem.mol import Molecule

    return Molecule(
        atom_type=np.concatenate([m1.atom_type, m2.atom_type]),
        pos=np.concatenate([m1.pos, m2.pos + np.float32([6.0, 0.0, 0.0])]),
        bond_index=np.concatenate([m1.bond_index,
                                   m2.bond_index + m1.num_nodes], 1),
        bond_type=np.concatenate([m1.bond_type, m2.bond_type]))


def check_engines(out_k, out_f, label, tol, report):
    """A bf16 engine's score planes against the f32 engine's."""
    import torch

    for key, mask in (("edge_inv_global", out_f.edge_mask),
                      ("edge_inv_local", out_f.local_mask)):
        ref = torch.where(mask, getattr(out_f, key), 0.0)
        diff = (torch.where(mask, getattr(out_k, key), 0.0) - ref).abs().max()
        rel = float(diff) / max(float(ref.abs().max()), 1e-6)
        report[f"engine_rel_err_{label}_{key}"] = rel
        print(f"{label} vs f32 engine {key}: rel err {rel:.3e} (tol "
              f"{tol})", flush=True)
        if not rel < tol:
            raise SystemExit(f"{label} engine disagrees with f32 on {key}")


def run_slice(runner, engine, mols, num_confs, label, report) -> dict:
    """Generate with `runner`, K1's counts set to 0 just before and read
    just after: the variant of `engine` must have launched once per
    forward run, and every position must be finite."""
    import numpy as np
    import torch

    from agdiff_torch.kernels import stack_packed as k1
    from agdiff_torch.models.fast_forward import engine_options

    for m in mols:
        got = runner._engine_for(runner._bucket_for(m))
        if got != engine:
            raise SystemExit(f"{label}: engine {got!r}, expected {engine!r}")
    tight, mode, approx = engine_options(engine)
    name = k1.variant(mode, approx, tight)
    fwd = runner.forward(engine)
    torch.cuda.synchronize()
    k1.launches.clear()
    calls0 = fwd.calls
    t0 = time.time()
    results = runner.run(mols, seed=SEED, num_confs=num_confs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, forwards = k1.launches[name], fwd.calls - calls0
    others = {k: c for k, c in k1.launches.items() if k != name and c}
    for m in results:
        pg = m.meta["pos_gen"]
        if pg.shape != (num_confs, m.num_nodes, 3):
            raise SystemExit(f"{label}: bad conformer shape {pg.shape}")
        if not np.isfinite(pg).all():
            raise SystemExit(f"{label}: non-finite conformer positions")
    if launches != forwards or launches == 0 or others:
        raise SystemExit(f"{label}: K1 {name} launches {launches}, other "
                         f"variants {others}, forwards {forwards}")
    n_conf = sum(m.meta["pos_gen"].shape[0] for m in results)
    row = dict(engine=engine, variant=name,
               buckets=sorted({runner._bucket_for(m) for m in mols}),
               atoms=[m.num_nodes for m in mols], chunk=runner.chunk_size,
               steps=runner.sampler_config.n_steps, forwards=forwards,
               k1_launches=launches, wall_s=wall,
               ms_per_step=wall * 1e3 / forwards, conformers=n_conf,
               conformers_per_s=n_conf / wall)
    report["slices"][label] = row
    print(f"{label}: {engine}, buckets {row['buckets']}, atoms "
          f"{row['atoms']}, {num_confs} conformers each, {forwards} "
          f"forwards, K1 {name} launches {launches}; "
          f"{row['ms_per_step']:.3f} ms/step, "
          f"{row['conformers_per_s']:.2f} conformers/s ({wall:.1f} s)",
          flush=True)
    return row


def profile_slice(runner, engine, mol, bucket, chunk, label, report):
    """Where the time goes: torch.profiler over PROFILE_STEPS ladder steps
    of one chunk (`mol` repeated `chunk` times in `bucket`) on the
    engine's forward, with the pair list built once as the runner does.
    Reports the device's busy time (the union of kernel intervals), its
    idle share of the host-clock window, K1's share, and the kernels that
    took the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.sampling.langevin import (
        SamplerConfig,
        build_fast_sampler,
    )

    dev = runner.device
    sampler = build_fast_sampler(
        runner.forward(engine), runner.diffusion,
        SamplerConfig(n_steps=PROFILE_STEPS, w_global=0.3),
        pair_capacity=runner._capacity_for(mol, engine))
    batch = pad_molecules([mol] * chunk, bucket, batch_size=chunk,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pos0 = torch.randn(batch.pos.shape, generator=gen, device=dev)
    sampler(batch, pos0, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler(batch, pos0, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"profile {label}: the profiler recorded no device kernels; "
              f"device busy share not measured", flush=True)
        report["profiles"][label] = None
        return
    busy, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    k1_us = sum(t for n, t in by_name.items() if "stack_kernel" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    report["profiles"][label] = dict(
        engine=engine, steps=PROFILE_STEPS, batch=chunk, bucket=bucket,
        wall_us=wall_us, device_busy_us=busy, idle_share=1.0 - busy / wall_us,
        k1_us=k1_us, k1_share_of_busy=k1_us / busy, kernels=len(spans),
        top=[dict(name=n[:80], us=t) for n, t in top])
    print(f"profile {label}: {PROFILE_STEPS} steps of B={chunk} N={bucket} "
          f"on {engine}: host window {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms (idle share {1.0 - busy / wall_us:.3f}), K1 "
          f"{k1_us / 1e3:.3f} ms = {k1_us / busy:.3f} of device time, "
          f"{len(spans)} kernels", flush=True)
    for n, t in top:
        print(f"  {t / 1e3:9.3f} ms  {n[:80]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability 9.0, got {cap}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from agdiff_torch.config import load_config
    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.kernels import build
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.models.tight_forward import build_tight_forward
    from agdiff_torch.models.weights import init_random
    from agdiff_torch.ops.pairs import pair_capacity_for
    from agdiff_torch.sampling.langevin import SamplerConfig

    # float32 products in full float32, as in the JAX reference's CPU runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "k1_checks": [], "slices": {},
              "profiles": {}, "levels": {}}

    def dump():
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.time()
    log = build.build("stack_packed")
    report["build_s"] = time.time() - t0
    report["build_log"] = log
    print(f"built stack_packed in {report['build_s']:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)

    # ---- 3. K1 against its plain version ------------------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qcfg = load_config(os.path.join(ROOT, "configs", "qm9_fast.yml")).model
    qmodel = init_random(DualEncoderEpsNetwork(qcfg), SEED).to(dev).eval()
    qfwd = build_fast_forward(qcfg, qmodel, "pksf")
    qmols = load_fixture()
    dconf = load_config(os.path.join(ROOT, "configs", "drugs_fast.yml"))
    dcfg = dconf.model
    dmodel = init_random(DualEncoderEpsNetwork(dcfg), SEED).to(dev).eval()
    dmols = load_fixture("drugs_synthetic")
    # the same weights on the CPU, where K1's wrapper takes the plain version
    qcpu = init_random(DualEncoderEpsNetwork(qcfg), SEED).eval()
    dcpu = init_random(DualEncoderEpsNetwork(dcfg), SEED).eval()
    cases, failures = {}, []
    for label, n, b in (("triu_B128_N32", 32, 128), ("triu_B48_N64", 64, 48)):
        batch = pad_molecules([qmols[i % len(qmols)] for i in range(b)], n,
                              device=dev)
        batch = batch.replace(pos=torch.randn(
            batch.pos.shape, generator=gen, device=dev)
            * batch.node_mask[..., None])
        kw, _ = qfwd.stack_inputs(batch)
        cases[label], failed = check_k1(
            kw, batch.node_mask, label, "full", False, QM9_LIMITS,
            build_fast_forward(qcfg, qcpu, "pksf").stack, report)
        failures += failed
    big = union(dmols[0], dmols[2])
    tight_cases = (
        ("tight_B48_N64", "tight-pksf", dmols[0], 64),
        ("tight_B48_N80", "tight-pksf", dmols[3], 80),
        ("tight_B48_N96", "tight-pksf", dmols[3], 96),
        ("tight_B48_N128", "tight-pksf", big, 128),
        ("schnet_B48_N64", "tight-pks", dmols[0], 64),
        ("gin_B48_N64", "tight-pksg", dmols[0], 64),
        ("full_approx_B48_N64", "tight-pksf-approx", dmols[0], 64))
    for label, engine, mol, n in tight_cases:
        fwd = build_tight_forward(dcfg, dmodel, engine)
        batch = random_batch(mol, n, DRUGS_CHUNK, gen)
        pairs = fwd.prepare(batch, pair_capacity_for(mol.num_nodes, 256))
        kw, _ = fwd.stack_inputs(batch, pairs)
        cases[label], failed = check_k1(
            kw, batch.node_mask, label, fwd.mode, fwd.approx, DRUGS_LIMITS,
            build_tight_forward(dcfg, dcpu, engine).stack, report)
        failures += failed
        if label in ("tight_B48_N64", "tight_B48_N96"):
            failures += check_levels(kw, label, report)
    dump()

    # ---- 4. the QM9 slice ---------------------------------------------------
    check_engines(qfwd(pad_molecules(qmols, 32, device=dev)),
                  build_fast_forward(qcfg, qmodel, None)(
                      pad_molecules(qmols, 32, device=dev)), "pksf",
                  ENGINE_TOL, report)
    runner = GenerationRunner(qmodel, qcfg, make_diffusion(qcfg),
                              SamplerConfig(n_steps=N_STEPS, w_global=0.3),
                              buckets=(32,), chunk_size=CHUNK, device=dev)
    qm9 = run_slice(runner, "pksf", qmols, CHUNK, "qm9_slice", report)

    # ---- 5. the Drugs slice -------------------------------------------------
    one = pad_molecules([dmols[0]] * 4, 64, device=dev)
    check_engines(build_tight_forward(dcfg, dmodel, "tight-pksf")(one),
                  build_tight_forward(dcfg, dmodel, "tight")(one),
                  "tight-pksf", DRUGS_ENGINE_TOL, report)
    # the same comparison with K1's plain version, on the CPU
    cpu_one = pad_molecules([dmols[0]] * 4, 64)
    check_engines(build_tight_forward(dcfg, dcpu, "tight-pksf")(cpu_one),
                  build_tight_forward(dcfg, dcpu, "tight")(cpu_one),
                  "tight-pksf_plain_cpu", DRUGS_ENGINE_TOL, report)
    drugs = GenerationRunner(dmodel, dcfg, make_diffusion(dcfg),
                             SamplerConfig(n_steps=N_STEPS, w_global=0.3),
                             buckets=dconf.buckets, chunk_size=DRUGS_CHUNK,
                             device=dev)
    slices = {}
    for label, mols in (("drugs_bucket64", dmols[:2]),
                        ("drugs_above64", dmols[2:])):
        slices[label] = run_slice(drugs, "tight-pksf", mols, DRUGS_CHUNK,
                                  label, report)
    for engine in ("tight-pks", "tight-pksg", "tight-pksf-approx"):
        runner_v = GenerationRunner(
            dmodel, dcfg, make_diffusion(dcfg),
            SamplerConfig(n_steps=VARIANT_STEPS, w_global=0.3),
            buckets=dconf.buckets, chunk_size=DRUGS_CHUNK, device=dev,
            engine=engine)
        slices[engine] = run_slice(runner_v, engine, dmols[:1], DRUGS_CHUNK,
                                   f"drugs_{engine}", report)
    dump()

    # ---- 6. where the time goes ---------------------------------------------
    profile_slice(runner, "pksf", qmols[0], 32, CHUNK, "qm9", report)
    profile_slice(drugs, "tight-pksf", dmols[0], 64, DRUGS_CHUNK, "drugs",
                  report)
    dump()
    if failures:
        raise SystemExit("\n".join(failures))

    # ---- 7. result lines ---------------------------------------------------
    def entry(name, case, launches):
        c = cases[case]
        return dict(name=name, route="cuda",
                    source="agdiff_torch/kernels/csrc/stack_packed.cu",
                    replaces="agdiff_tpu/ops/pallas/stack_packed.py:104",
                    launches=launches, max_abs_err=c["max_abs_err"],
                    ms=c["ms"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                    library_ms=None)

    kernels = [
        entry("stack_full:triu", "triu_B128_N32", qm9["k1_launches"]),
        entry("stack_full:tight", "tight_B48_N64",
              slices["drugs_bucket64"]["k1_launches"]
              + slices["drugs_above64"]["k1_launches"]),
        entry("stack_schnet:tight", "schnet_B48_N64",
              slices["tight-pks"]["k1_launches"]),
        entry("stack_gin:tight", "gin_B48_N64",
              slices["tight-pksg"]["k1_launches"]),
        entry("stack_full_approx:tight", "full_approx_B48_N64",
              slices["tight-pksf-approx"]["k1_launches"]),
    ]
    report["kernels"] = kernels
    dump()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
