#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (agdiff_torch) on one H100.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. a CUDA card of compute capability 9.0 is required; its name and power
     limit are printed as nvidia-smi reports them;
  2. the CUDA sources under agdiff_torch/kernels/csrc (stack_packed.cu,
     fused.cu, block_packed.cu, mono.cu) are built with nvcc, one process
     each, all started together; their ptxas register and spill lines are
     printed;
  3. K1 (the whole-stack kernel) is held against its plain PyTorch version
     on the card, on the inputs the main paths give it, output by output
     (each score plane, or h and hl over real nodes, on its own scale), at
     the cluster size R (CTAs per graph) the wrapper picks and at R = 1,
     each timed, and planted faults in the plain version must break the
     same limits;
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
     - at the runner's default chunk (triu, B=64/N=32, R=2) and a tail
       chunk (tight, B=16/N=64, R=8), also at R / 2;
     each K1 time is read twice: as a lone call (`ms`, the kernels line)
     and behind a ~1 ms spin of the card (`ms_spun`, the card's time with
     no host launch overhead in it);
     then K3 (f32, bf16), K5, K4 (f32, bf16) and K2 (exact, '-approx',
     and f32 on path D's inputs taken at f32) likewise, on the inputs of
     each path's first call at the full width of configs/qm9_default.yml
     (f32) or qm9_fast.yml (bf16), B=128, N=32, with planted faults (a
     dropped filter or first-layer bias, the softplus shift dropped, the
     mask ignored, the relu dropped), each timed as a lone call (`ms`)
     and behind a card spin (`ms_spun`), K5 also over a run of
     RUN_LAUNCHES back-to-back launches (`ms_run`, CUDA events around the
     run over its count, the run queued behind a spin the host outlasts
     in launching it); K4 also on the local head's
     inputs (its second call) and on a mask of every real-atom pair, with
     each mask's density and the bound over its masked pairs beside the
     bound over all N x N pairs, and a third planted fault (each graph's
     last masked pair dropped), and on the global head's inputs at
     positions spread 6 A (the ladder's top, a sparse radius mask); K2,
     K3 and K4 print the layout level
     and grid of their launch, and their other layout levels (K2 and K3
     bf16: 1; K3 f32: 1, 2 and 3) must give the same bits (timed beside
     it);
  4. the QM9 slice: GenerationRunner generates conformers for the
     molecules of agdiff_torch/data/fixtures/qm9_synthetic.json on the
     'pksf' engine (bucket 32, chunk 128, w_global 0.3, a 250-step suffix
     of the 5000-step ladder) with seeded random weights; a small batch is
     also checked against the f32 plain engine; then the engines
     'pallas' (f32 against the f32 engine, 2e-4; bf16 within 5%; with
     pack_pairs=False against the packed form, 2e-4) and 'pk' (within 5%),
     and their paths over the same molecules, 128 conformers each: A
     'pallas' f32 and B 'pallas' bf16 (build_fast_sampler, 50 steps), C
     pack_pairs=False at f32 and at bf16 (20 steps), D 'pk' (50 steps)
     and D' 'pk-approx' (20 steps) through GenerationRunner; each kernel's
     launches must equal the forwards run times its count per forward (K3
     6, K5 4, K4 2, K2 6) and no other kernel may launch;
  5. the Drugs slice: GenerationRunner on configs/drugs_fast.yml runs the
     molecules of agdiff_torch/data/fixtures/drugs_synthetic.json (50 and
     56 atoms in bucket 64, 69 and 73 atoms above it) on 'tight-pksf'
     (chunk 48, w_global 0.3, 250 steps), and the engines 'tight-pks',
     'tight-pksg' and 'tight-pksf-approx' for a few steps each; a small
     batch is checked against the f32 'tight' engine, beside the same
     check with K1's plain version on the CPU;
     in every slice and engine run, K1's launches of the path's variant
     must equal the forwards run, counted from 0 just before it, and
     every position must be finite;
  5b. engine 'mono' (K6, the whole forward in one launch,
     agdiff_torch/kernels/csrc/mono.cu): K6 is held against its plain
     version per plane (each on its working-graph or bond mask, on its own
     scale; off the masks every value must be exactly 0) at bf16 on
     configs/qm9_fast.yml at B=128/N=32 and on drugs_fast.yml at
     B=48/N=64, and at f32 on qm9_default.yml at B=128/N=32 and on
     drugs_fast.yml at B=48/N=64, with planted faults (the type tables
     replaced by their row 0, the cutoff mask dropped, lm ignored, the
     softplus shift dropped, each graph's last working pair dropped), two
     launches and every layout level giving the same bits, each case
     timed beside its bound (as a lone call, behind a card spin, and at
     every layout level), with its working-pair share of the triangle and
     the tiles K6 walks; at Drugs size the
     plain version on the CPU and the plain version fed K6's own encoder
     output are read beside it, to show where bf16 differences start;
     the engine is
     checked against the f32 engine on QM9 (bf16 within 5%, f32 within
     2e-4) and against f32 'tight' at Drugs size (15%), beside the same
     checks with the plain version on the CPU; paths E (qm9_fast, the
     four QM9 molecules, 128 conformers each, 100 steps), E-f32
     (qm9_default, 20 steps) and E-drugs (drugs_fast, the 50-atom
     molecule, bucket 64, 48 conformers, 20 steps) run through
     GenerationRunner(engine='mono') with K6's launches equal to the
     forwards and no other kernel; then the generation CLI runs as a
     subprocess on a reference .pt of the seeded QM9 model and the QM9
     molecules as an .npz (20 steps), and a second run must resume
     without generating;
  6. where the time goes: torch.profiler over a few ladder steps of one
     chunk of each slice, and of paths A, B, D and E, run eagerly
     (graph=False, the loop of earlier records), gives each hand
     kernel's share of the device time, the device's idle share and the
     largest kernels;
  7. graphed ladders (sampling/graphed.py; the runs of phases 4, 5 and 5b
     already replay graphs, the runner's default on a card): the same
     seed through the graphed ladder and the eager loop must give
     torch.equal positions and flags (and trajectories) on K1 over the
     triu set (QM9 'pksf', B=128, 100 steps), K1 over tight lists
     (Drugs 'tight-pksf', the 50- and then the 56-atom molecule in
     bucket 64 at one capacity, B=48, 50 steps each, then the first
     again: each new list's capture frees the last list's graphs), K6
     ('mono' bf16, 50 steps), K3-K5 (path C, f32, and C-bf16, 20 steps)
     and K2 (path D, 20 steps), and the sampler modes on 'pksf' (the
     strided ladder with DDIM at eta 1, 50 steps; Heun at eta 0, 25
     steps; a denoise tail of 10; a trajectory every 10 steps); each
     case also runs eagerly twice, and the two must agree bit for bit;
     each case prints its NaN flags and largest |position| (with random
     weights at full width the ladders diverge), each ladder's memory pool
     and the device memory reserved at the case's peak;
     GenerationRunner after `warm` (the retry's graphs too) gives the
     eager runner's samples bit for bit on the QM9 fixtures; 20 graphed
     steps of QM9, Drugs and paths E, C, C-bf16 and D are profiled
     (chip_profile.py --graph), and each hand kernel's name must appear
     in the replays' window as many times as the replays ran it (its
     graph's captured count times the replays); ms per step graphed and
     eager, capture times and idle shares are printed. The launch counts
     of phases 4-5b and of the kernels line, on graphed paths, are the
     launches recorded at capture times the replays
     (chip_smoke.launch_counts); these profiles are what shows the
     replays run the kernels;
     then the NaN guard (the sampler flags a graph that went non-finite,
     and the runner reruns it with clip_local 20): on each graphed path
     (QM9 'pksf' with each sampler mode, Drugs 'tight-pksf', E, C,
     C-bf16, D), atom 0 of graph 1 planted at NaN and at 1e30 A (whose
     distances overflow to inf, as a diverging ladder's do), one forward
     and a 4-step ladder through the hand kernels and through their plain
     twins on the card must give the same per-graph flags, graph 1
     flagged; the twins with every relu dropping NaN (the kernels' fmaxf
     before this check) must give other flags, on every path whose
     kernels hold a relu (D's K2 holds none); K4 (f32, bf16) and K5 with
     a NaN edge feature on and off the mask give the plain twin's
     non-finite elements (K4 0 off its mask, K5 NaN in the sum); and a
     random-weight QM9 'pksf' ladder (100 steps) and Drugs 'tight-pksf'
     ladder (50) through GenerationRunner report the graphs flagged and
     the clip_local retry, and fail if a graph past 1e20 A (where a
     squared distance overflows) is left unflagged;
  8. the test set: 16 synthetic QM9-size molecules (9 heavy atoms, three
     reference conformers) and 4 Drugs-size ones (20 heavy atoms, two
     pairs of one atom count) through GenerationRunner and
     PackedGenerationRunner (50 steps, clip_local 20, w_global 0.3, as
     bench.py runs random weights; conformers/s of each, captures
     included; K1 launched), the QM9 set also through `cli.generate
     --packed` in a subprocess; each packed samples file is scored by
     `python -m agdiff_torch.cli.eval_covmat` in a subprocess (every
     molecule must survive the filter; COV-R and MAT-R printed, of random
     weights), and each molecule's RMSD matrix natively and in numpy must
     agree to 1e-9; with strided DDIM at eta 0 (8 steps) and item seeds,
     a molecule packed with another at its own batch size gives its
     samples alone bit for bit, and the whole set packed (other batch
     sizes) within the engine's limit (5% at
     QM9 size, 15% at Drugs size) of the largest coordinate;
  9. training (train/*, cli/train.py) on configs/synthetic_qm9.yml at
     full width, f32 (TF32 off, asserted), B=64, bucket 32, molecules
     synthetic_dataset(512, seed=2021) split 0.9 / 0.1: one train step
     on the card against the same step on the CPU (the same init_like_jax
     weights, batch, timesteps and noise: the three losses, every
     gradient leaf, the running statistics, the parameters after the
     optimizer step, each on its own scale, STEP_LIMITS), with planted
     faults that must break the limits (BatchNorm in eval mode while
     training, the unbiased variance normalising, the local loss weight
     1, ~local dropped from the global mask), and packed_pairs against
     dense on the card within the same limits; then cli/train.py main
     (--deterministic): TRAIN_ITERS dense iterations (EMA 0.999,
     checkpoints every TRAIN_VAL_FREQ) whose losses must be finite and
     whose last 50 must average below the first 50, a resume from
     checkpoint RESUME_FROM whose iterations must equal the run's bit for
     bit (parameters, statistics, both Adams, EMA, generator, loader), and
     PACKED_ITERS packed_pairs iterations; a Trainer built directly,
     LOSS_ITERS = 2 x LOSS_LOG_FREQ + 1 iterations: at most LOSS_LOG_FREQ
     of the step's loss tensors alive at a log point (weakrefs), none but
     the last step's once train() returns, `losses` the logged losses,
     and torch.cuda.memory_allocated() the same after LOSS_ITERS more
     iterations; whether its TensorBoard writer is active (the tensorboard
     package installed), and if it is, its events against metrics.jsonl
     at float32; the run's log dir through
     cli/generate.py main (--ema, 4 held-out synthetic molecules, 50
     'pksf' steps, K1 launched) and cli/eval_covmat.py (every molecule
     scored); last, TRAIN_PROFILE_STEPS train steps of each layout timed
     (CUDA events), their peak memory, and profiled
     (device busy, idle share, the top device operations). One `train`
     line sums it up;
 10. the generation server (serve/server.py, cli/serve.py) and the
     engines of JAX's XLA path: (a) a QM9 server in this process
     (GenerationService.serve on a thread, qm9_fast.yml, 'pksf',
     PackedGenerationRunner, chunk 64, merging within 0.5 s, max_nodes
     32, a 50-step strided DDIM ladder at eta 0 with clip_local 20 and
     w_global 0.3), warmed for the QM9 fixtures' sizes at every batch
     size with the retry's ladders; six concurrent requests of two
     molecules x 8 conformers: every reply ok, at least two merged, K1's
     launches equal to the forwards and no other kernel, no ladder
     captured during requests, each merged request against its
     "batch": false run bit for bit where the chunk's batch size is the
     same (two one-chunk requests), and the merged replies equal to the
     packed runner's run of the same set bit for bit; across batch sizes
     the same set run directly at 2, 8 and 50 steps, within 5% of the
     largest coordinate after 2 (later steps printed); a Drugs molecule
     rejected as over capacity while the request merged with it is
     answered; a saved request scored by "evaluate"; request latency
     p50 and max, conformers/s, warm-up seconds, the warmed pools' MiB
     and the peak reserved memory printed; (b) a Drugs server
     ('tight-pksf', bucket 64) warmed for the 50- and 56-atom fixtures,
     requests alternating between them, alone and merged, with no
     capture; (c) `python -m agdiff_torch.cli.serve` in a subprocess on
     phase 5b's reference .pt, answering `--submit` ping, generate and
     shutdown and exiting 0; (d) 'slim', 'slim8', 'approx', 'pksf-e16'
     and 'stack' (f32) on QM9 and 'tight-slim', 'tight-slim8',
     'tight-approx', 'tight-pksf-e16' at Drugs size, each against the
     f32 engine (5%, 15% at Drugs size, 2e-4 for 'stack'; the slim8
     engines beside their plain CPU runs) and through GenerationRunner
     for 10 steps: K1's launches equal to the forwards on the '-e16' K1
     engines, no hand kernel on the others, positions finite;
 11. bf16 training, distillation and the distilled student, at the
     widths of configs/qm9_fast.yml (bf16, packed_pairs): (a) the bf16
     module on the card against the same module on the CPU
     (MODULE_BF16_LIMITS, each score plane on its mask) and against the
     f32 module of the same weights (the 5% engine gate), on the QM9
     fixtures; (b) one bf16 train step on the card against the CPU's
     (TF32 off; the losses, every gradient leaf and the running
     statistics, BF16_STEP_LIMITS), with planted faults that must break
     the limits (BatchNorm statistics at bf16, the position cast left
     out, one-output layers' biases dropped, the running statistics left
     unmoved); (c) cli/train.py on qm9_fast.yml as it stands (bf16,
     packed_pairs, EMA 0.999, step_chunk 16) with --synthetic 512 for
     FAST_ITERS iterations: losses finite and falling, a resume equal to
     the run bit for bit, it/s; (d) one distillation step on the card
     against the CPU's at f32 (STEP_LIMITS) and at bf16
     (BF16_STEP_LIMITS), each with planted faults (the teacher's second
     sub-step dropped, the first graph's sigma for every graph, the 'eps'
     weighting, clip_local left out); (e) cli/distill.py from (c)'s log
     dir (--ema_teacher, stages 32 and 16, DISTILL_ITERS iterations
     each): finite validation losses, a rerun that skips both stages,
     and stage 16 left as a cut after its first checkpoint leaves it
     resuming from that checkpoint; (f) the stage-16 student through
     cli/generate.py --fast (strided DDIM at eta 0, 16 steps, w_global
     0.3, clip_local 20) on 16 synthetic QM9-size molecules: K1's
     launches equal to the forwards, no other hand kernel, positions
     finite, 'pksf' within 5% of the f32 engine on one batch, the
     samples scored by cli/eval_covmat.py (printed, not gated); (g) the
     student served (GenerationService, 'pksf', warmed at start-up): a
     stream of four requests, then eight concurrent ones, each of two
     molecules x 4 conformers: every reply ok, no capture during
     requests, K1's launches equal to the forwards, latency p50 and max
     and conformers/s printed; (h) TRAIN_PROFILE_STEPS eager steps each of
     the bf16 train step and of the distill step at f32 and bf16 (B=64)
     timed and profiled;
 12. data parallelism (parallel/mesh.py, parallel/data_parallel.py):
     (a) cli/train.py --num_devices 1 (one spawned rank, NCCL) on
     synthetic_qm9.yml, DP_ITERS iterations under deterministic
     algorithms: losses and checkpoint torch.equal to the run without the
     flag; cli/generate.py --num_devices 1 --engine pksf: samples equal to
     the run without it; (b) two gloo ranks on card 0 (NCCL refuses two
     ranks on one device; launch's explicit backend): the data-parallel
     train step at f32 (STEP_LIMITS) and bf16 (BF16_STEP_LIMITS) against
     the single-process card step, with planted faults (per-rank
     BatchNorm statistics, statistics through an all-reduce without
     gradient, DDP's mean of per-rank means, each rank drawing its own
     noise) that must break them, ms/step per rank and the gradient
     all-reduce's ms; the runner's 'pksf' ladder (QM9, B=128 as 2 x 64)
     and 'tight-pksf' ladder (the 50-atom Drugs molecule, B=48 as 2 x
     24): each rank's K1 launches equal to its forwards and no other
     kernel, the gathered samples bit for bit those of single-process
     runs at each rank's batch size on the same noise slice, and within
     5% (QM9) and 15% (Drugs) of the whole batch's run after 8 steps;
     phase 10's six-request QM9 burst through a service over the two
     ranks: replies ok and merged, no capture after warm-up on either
     rank, K1 launches equal to forwards on each; (c) on a machine with
     two cards or more, cli/generate.py --num_devices 2 over NCCL, else
     a line saying the machine has one card; two ranks sharing a card
     give no scaling figure;
 13. configuration variants (the configs above changed in code): gelu
     score heads (mlp_act 'gelu') through K1, triu on qm9_fast.yml at
     B=128/N=32 and tight on drugs_fast.yml at B=48/N=64, exact and
     '-approx', at the wrapper's R and R = 1 and 2 and every layout level,
     with the phase-3 faults plus relu heads in place of gelu and, under
     '-approx', the exact gelu in place of the polynomial; through K4
     (f32 on qm9_default.yml, bf16 on qm9_fast.yml, the global and local
     heads' inputs of 'pallas' with pack_pairs=False, with the phase-3b
     faults plus relu in place of gelu, 0 off the mask); through K6 (bf16
     QM9 and Drugs, f32 QM9, MONO_LIMITS, plus relu heads as a fault);
     the gelu engines against the f32 engines (5%, 15% at Drugs size,
     2e-4 for f32 'pallas'), the runner on 'pksf' and 'tight-pksf'
     (VARIANT_LADDER graphed steps) and their '-approx' forms, paths C
     and C-bf16 with gelu heads (K4 2 a forward) and E and E-f32 with
     gelu heads (K6 1 a forward); the 'gaussian' edge encoder on
     synthetic_qm9.yml: the train step on the card against the CPU's
     under STEP_LIMITS with phase 9's faults, cli/train.py for
     GAUSS_ITERS iterations, cli/generate.py on the module path (no hand
     kernel) and cli/eval_covmat.py; phase 8's synthetic QM9 test set as
     a reference-layout .pkl (PyG 1.x Data, one per conformer) through
     cli/generate.py --fast --engine pksf on a reference .pt of the
     seeded qm9_fast model, then scored;
 14. sharded and pipelined training (parallel/sharded.py, pipeline.py):
     (a) the port's specs of synthetic_qm9.yml's and qm9_fast.yml's
     states against JAX's (tests/torch_port_jax_specs.json, written and
     checked by the CPU tests; specs taken on the port's (out, in) shapes
     must differ); two gloo ranks on card 0, a (1, 2) mesh: fsdp and tp
     train steps of both configs (B=64) against the single-process card
     step under STEP_LIMITS plus the gradient norm (f32, SHARD_LIMITS)
     and BF16_STEP_LIMITS (bf16), with planted faults (an fsdp gradient
     shard left unsummed, a row-parallel partial left unreduced, the
     clip's norm from the rank's own shards) that must break them; each
     rank's bytes of the state at most SHARD_STATE_SHARE of the whole;
     ms/step per rank and the all-gather and reduce-scatter of the
     sharded parameters; (b) four gloo ranks on card 0: the ('dcn', 'dp')
     = (2, 2) DP step of synthetic_qm9.yml against the single step and
     the flat 4-rank DP step under STEP_LIMITS, the cross-slice level
     skipped as a fault; (c) schnet_pipeline on qm9_fast.yml's 'pallas'
     forward (6 blocks, 2 stages of 3) over two ranks, QM9 B=128 N=32 as
     4 microbatches of 32: h torch.equal to the stage bodies run in
     sequence on one rank, K3 (bf16) within its limits of its plain
     version at every block, K3's launches S x (M + S - 1) x blocks / S
     = 30 and no other kernel, a rotation two stages on as a fault, ms
     per pipelined forward beside the sequential stack's; (d) the
     gradient of a projection of h through pipeline_apply (plain stage
     body, synthetic_qm9.yml, 4 x 8 graphs) against the sequential stack
     under STEP_LIMITS' gradient limits;
 15. spatial (node-axis) sharding and the protein path: (a) two gloo
     ranks on card 0, a ('dp', 'sp') = (1, 2) mesh: the sp train step of
     synthetic_qm9.yml (f32, dense and packed_pairs) at N=32, B=8, at
     N=256, B=2 and at N=512, B=1, and qm9_fast.yml as written (bf16,
     packed_pairs) at N=32 and N=256 and dense at N=256 (the training
     batch's first graphs, padded; SP_LAYOUTS) against the
     single-process card step of the same layout under SHARD_LIMITS (f32)
     and BF16_STEP_LIMITS (bf16), the moments' worst leaf beside them; the
     ranks' parameters equal; each rank's peak allocation over
     SP_TIMED_STEPS steps as a share of the single step's, at most
     SP_MEMORY_SHARE at N=256; ms per step; each rank's owned pairs under
     packed_pairs; (b) planted faults (the transposed eq terms dropped,
     per-rank BatchNorm statistics, h_j from the rank's own rows, a
     per-rank loss count; packed: the j-side messages kept on the owner,
     the mirror's lower half dropped, a pair owned by two ranks) that
     must break the f32 limits; (c) python -m agdiff_torch.examples.alanine_dipeptide on
     qm9_fast.yml's seeded weights ('pksf', K1), 64 samples x 50 steps at
     --clip_local 20: samples.pdb parses back to 64 models, every sample
     finite; (d) subgraph_position_scores over the dipeptide (max_nodes
     32, cutoff 3 A) through 'pksf' against K1's plain twin: each
     subgraph's planes at K1's triu limits, one K1 launch a subgraph;
 16. the host modules and the RDKit seam: (a) the native relaxation
     (native/relax.cpp, built by g++ on the machine) on two Drugs-size
     rich-chemistry molecules (synthetic_dataset(2, seed=7, chem='rich',
     min_heavy=20, max_heavy=28)): each relaxation call within 1e-6 of
     the numpy body, the whole dataset of two native runs bit-equal; ms
     per molecule native against numpy, relaxation and generation;
     (b) utils/profiling.py on the graphed 'pksf' ladder (qm9_fast.yml's
     seeded weights, QM9 B=128 N=32, PROFILED_STEPS steps): trace()
     writes a trace that names K1's kernel, Timer with block_on reads no
     less than CUDA events around the same steps, device_memory_stats()
     reports bytes in use and a peak no smaller; (c) the main of
     agdiff_torch.examples.synthetic_end_to_end at E2E_ITERS iterations
     (f32, hidden 64): MAT-R and COV-R@1 A untrained -> trained, the
     example's assertion that training lowers MAT-R; (d) SMILES
     generation's model half, cli/smiles_generation.py
     generate_for_molecule, on a qm9_synthetic.json molecule from a bf16
     checkpoint of 2 iterations of cli/train.py on qm9_fast.yml, --fast
     ('pksf', K1), SMILES_STEPS steps, --num_samples auto: 5 x (1100 //
     atoms) finite samples; (e) without RDKit or psikit on the machine,
     CovMatEvaluator(use_force_field=True), smiles_to_molecule,
     PropertyCalculator() and cli.preprocess geom each raise ImportError
     naming the package;
 17. a checkpoint of the JAX package in the port (f32, TF32 off): the
     committed converted fixture agdiff_torch/data/fixtures/
     jax_checkpoint_small (hidden 32, 2 + 2 convs, two JAX train steps,
     EMA on, the Adams at two learning rates) resumed on the card: the
     restored Adams' learning rates those of its plateau states; the eval
     forward within 2e-4 + 2e-4 |ref| of JAX's stored planes; one train
     step with the stored t and noise within STEP_LIMITS of JAX's stored
     losses and gradient leaves, the gradient norm within 1e-4, the
     stored parameter leaves' updates and EMA leaves within their limits;
     planted faults in the reader (the two Adams' states swapped, the
     running statistics not carried, the EMA shadow left at the
     parameters) must break a limit; cli/train.py resumes a copy of the
     log dir for JAX_RESUME_ITERS iterations and writes the port's
     checkpoint into it, finite losses; cli/generate.py on it at bf16,
     --engine pksf (K1), JAX_GEN_STEPS steps on JAX_GEN_MOLS synthetic
     QM9-size molecules: finite samples, K1 launched, and K1 at this
     width (hidden 32) on its first step's inputs against its plain
     version at K1's triu limits, with its planted faults and every
     layout level (the row joins K1's triu entry of the result line);
 18. one JSON line lists each kernel variant and its numbers, then the
     card's line, then the last line {"ok": true, "device": {...}}.
Every phase prints its seconds. Details also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 0
N_STEPS = 250
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
SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock (cuda_time's spin)
# cuda_time_run: a run of back-to-back launches (K5's `ms_run`) behind a
# ~40 ms spin, longer than the host takes to launch the run
RUN_LAUNCHES = 200
RUN_SPIN_CYCLES = 40 * SPIN_CYCLES
F32_ENGINE_TOL = 2e-4   # two f32 engines: summation order only
SOURCES = ("stack_packed", "fused", "block_packed", "mono")
# the TPU kernel each new kernel replaces (file:line of its function)
REPLACES = {
    "block_agg": "agdiff_tpu/ops/pallas/fused.py:181",
    "pair_score": "agdiff_tpu/ops/pallas/fused.py:82",
    "pair_score_gelu": "agdiff_tpu/ops/pallas/fused.py:82",
    "mono_gelu": "agdiff_tpu/ops/pallas/monolithic.py:240",
    "gine": "agdiff_tpu/ops/pallas/fused.py:142",
    "packed_block": "agdiff_tpu/ops/pallas/block_packed.py:53",
    "packed_block_approx": "agdiff_tpu/ops/pallas/block_packed.py:53",
    "mono": "agdiff_tpu/ops/pallas/monolithic.py:240",
}


# the launch counter names of each hand kernel (graphed profiles)
KERNEL_COUNTERS = {"K1": "stack_packed/", "K2": "block_packed/",
                   "K3": "fused/block_agg:", "K4": "fused/pair_score:",
                   "K5": "fused/gine:", "K6": "monolithic/"}
# phase 7: graphed ladders
GRAPH_QM9_STEPS = 100
GRAPH_STEPS = 50        # Drugs (each molecule), E, the sampler modes
GRAPH_SHORT_STEPS = 20  # paths C, C-bf16 and D
# phase 7: the NaN guard. Planted in graph 1's atom 0: NaN (its distances
# NaN), and 1e30 A (its distances overflow to inf, as a diverging
# ladder's do); a ladder block of NAN_STEPS steps at the clean end.
NAN_PLANTS = (("nan", float("nan")), ("far", 1e30))
NAN_STEPS = 4
# a recentred graph with an atom past this (A) has a pair whose squared
# distance overflows float32 (3.4e38): its forward goes non-finite, so the
# guard must have flagged it
OVERFLOW_POS = 1e20
# phase 8: the test set
SET_STEPS = GRAPH_STEPS  # the runners' ladder (clip_local 20, bench.py's)
SET_QM9, SET_DRUGS = 16, 4
DDIM_STEPS = 8          # packed against alone: strided DDIM at eta 0
RMSD_PATHS_TOL = 1e-9   # native against numpy confusion matrices (A)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int = 20, spin: bool = False) -> float:
    """Median ms of `reps` timed calls (CUDA events), after two warm-ups.
    A lone call's events also hold the host's time to launch it when the
    card gets to the start event first. With `spin`, each timed call is
    queued behind a ~1 ms spin of the card (torch.cuda._sleep), so that
    the host has launched it before the card reaches the start event: the
    card's time alone (K1's `ms_spun`, beside the plain `ms`)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_time_run(fn, launches: int = None, reps: int = 5) -> tuple:
    """(ms a launch, host ms a launch): CUDA events around a run of
    `launches` back-to-back calls, over the count, the median of `reps`
    runs after two warm-ups. Each run is queued behind a spin of
    RUN_SPIN_CYCLES, so the host has launched it all before the card
    reaches the start event (the host's ms a launch, printed beside it,
    says whether the spin outlasted the launching)."""
    import torch

    launches = launches or RUN_LAUNCHES
    for _ in range(2):
        fn()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(RUN_SPIN_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / launches)
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times), statistics.median(host)


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


def errors(got, ref, mask=None, scale=None) -> dict:
    """|got - plain| over the entries `mask` selects, as shares of
    `scale` (default: the max |plain value| there): max, median, p99, and
    the share of entries off by more than 1% of it."""
    import torch

    if mask is not None:
        got, ref = got[mask], ref[mask]
    scale = float(ref.abs().max()) if scale is None else scale
    d = (got - ref).abs().flatten() / scale
    if d.numel() == 0:
        d = torch.zeros(1, device=got.device)
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


def planted_faults(kw, ref, mode, approx, band=False):
    """Wrong versions of K1's function, each the plain version with one
    planted fault, to show the gate fails them: (name, outputs). `band`:
    the inputs are head_band's, where the exact gelu in place of
    ops/approx.py's shows."""
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
    if mode == "full" and prm.act == "gelu":
        yield "relu heads in place of gelu", plain(
            params=dataclasses.replace(prm, act="relu", _packed={}))
        if approx and band:
            saved = k1.head_activation
            k1.head_activation = lambda act, approx=False: saved(act)
            try:
                exact = plain()
            finally:
                k1.head_activation = saved
            yield "exact gelu in place of the polynomial", exact


HEAD_BAND = 2.5   # median |pre-activation| of head_band's score heads


def head_band(kw, approx, target=HEAD_BAND):
    """K1's inputs `kw` with each score head's first layer (w1, b1) scaled
    so that the median |pre-activation| of its first gelu on these inputs
    is `target`. There ops/approx.py's gelu and the exact one differ (up
    to ~1e-3 for |x| ~ 2-4); near 0 and past |x| ~ 5 they agree to f32's
    last bits, and the main path's inputs sit there (median |x| ~ 0.3 on
    the global head, ~ 8-15 on the local one), so that a kernel taking
    the wrong form passes K1's limits on them."""
    import dataclasses

    from agdiff_torch.kernels import stack_packed as k1
    from agdiff_torch.ops.pairs import gather_nodes

    prm, pairs = kw["params"], kw["pairs"]
    h, hl = k1.packed_stack_forward_plain(**kw, mode="gin", approx=approx)
    heads = []
    for hx, e, p6 in ((h, kw["e_packed"], prm.grad_global),
                      (hl, kw["e_packed_local"], prm.grad_local)):
        c = hx.shape[-1]
        hb = hx.to(e.dtype).float()
        x = ((gather_nodes(hb, pairs.iu) * gather_nodes(hb, pairs.ju))
             @ p6[0][:c].float() + e.float() @ p6[0][c:].float()
             + p6[1].float())
        scale = target / float(x.abs().median())
        heads.append((p6[0] * scale, p6[1] * scale, *p6[2:]))
    return dict(kw, params=dataclasses.replace(
        prm, grad_global=heads[0], grad_local=heads[1], _packed={}))


def check_k1(kw, node_mask, label, mode, approx, limits, cpu_params,
             report, forced=(1,), band=False) -> tuple:
    """K1 against its plain version on a main path's inputs, output by
    output, at the wrapper's cluster size R and at each forced R in
    `forced` (1: one CTA per graph), each within the limits and each timed
    (`ms`, and `ms_spun`: the card's time alone, cuda_time); also the
    planted faults against the same limits, and, for scale, the plain
    version on the CPU (`cpu_params`: the same weights there) against the
    plain version on the card: how far last-bit differences of the same
    function (each device's exp and log, its summation order) carry at
    this size (None: no CPU run). Returns the case's row (at the
    wrapper's R) and its failures."""
    import torch

    from agdiff_torch.kernels import stack_packed as k1

    def kernel(ranks=None):
        return k1.packed_stack_forward(**kw, mode=mode, approx=approx,
                                       ranks=ranks)

    def plain():
        return k1.packed_stack_forward_plain(**kw, mode=mode, approx=approx)

    got, again = kernel(), kernel()
    ranks = k1.last_launch["ranks"]
    others = [r for r in forced if r != ranks]
    outs_at = {r: kernel(r) for r in others}
    ref = plain()
    torch.cuda.synchronize()
    outs = output_errors(got, ref, mode, node_mask)
    outs_at = {r: output_errors(o, ref, mode, node_mask)
               for r, o in outs_at.items()}
    flat = (lambda x: (x,)) if mode == "schnet" else tuple
    repro = all(torch.equal(g, a) for g, a in zip(flat(got), flat(again)))
    faults = {name: output_errors(out, ref, mode, node_mask)
              for name, out in planted_faults(kw, ref, mode, approx, band)}
    ms, ms_spun = cuda_time(kernel), cuda_time(kernel, spin=True)
    at_ranks = {r: dict(ms=cuda_time(lambda: kernel(r)),
                        ms_spun=cuda_time(lambda: kernel(r), spin=True),
                        outputs=outs_at[r]) for r in others}
    plain_ms = cuda_time(plain)
    cross = None
    if cpu_params is not None:
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
    gelu = mode == "full" and kw["params"].act == "gelu"
    row = dict(case=label, mode=mode, approx=approx,
               variant=k1.variant(mode, approx, pairs.tight, gelu), B=b,
               N=n, P=p,
               valid_pairs=pairs.num_valid,
               layout_level=k1.layout(n, kw["h0"].shape[2])[0],
               ranks=ranks, outputs=outs, at_ranks=at_ranks,
               limits={k: limits[k] for k in outs},
               planted_faults=faults, plain_cpu_vs_plain=cross,
               bitwise_reproducible=repro,
               max_abs_err=max(r["max_abs_err"] for r in outs.values()),
               ms=ms, ms_spun=ms_spun, plain_ms=plain_ms, flops=flops,
               bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    report["k1_checks"].append(row)

    def line(rows):
        return "; ".join(
            f"{name}: max {r['max_rel']:.3e} median {r['median_rel']:.3e} "
            f"p99 {r['p99_rel']:.3e} beyond-1% {r['beyond_1pct']:.3e} "
            f"(max|value| {r['max_abs_value']:.3e})"
            for name, r in rows.items())

    times = "".join(f", {a['ms']:.3f} ms ({a['ms_spun']:.3f}) at R={r}"
                    for r, a in at_ranks.items())
    print(f"K1 {label} [{row['variant']}, layout {row['layout_level']}, "
          f"R={ranks}]: B={b} N={n} P={p} valid {pairs.num_valid}; "
          f"|kernel - plain| as shares of each output's max|value|: "
          f"{line(outs)}; two launches bitwise equal {repro}; kernel "
          f"{ms:.3f} ms ({ms_spun:.3f} behind a spin) at R={ranks}{times}, "
          f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    for r, a in at_ranks.items():
        print(f"  at R={r}: {line(a['outputs'])}", flush=True)
    if cross is not None:
        print(f"  plain version on the CPU vs on the card: {line(cross)}",
              flush=True)
    failures = [f"K1 {label}: kernel breaks {name} {k} at R={r}"
                for r, rows in [(ranks, outs)] + [
                    (r, a["outputs"]) for r, a in at_ranks.items()]
                for name, k in broken_limits(rows, limits)]
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


def check_levels(kw, label, report, approx=False) -> list:
    """K1 (mode 'full') at every layout level that fits these inputs (node
    regions in shared memory, node temporaries in global scratch, all
    node regions in global scratch): each must give the bits of the
    wrapper's choice; each is timed."""
    import torch

    from agdiff_torch.kernels import stack_packed as k1

    n, h = kw["h0"].shape[1:]
    chosen = k1.layout(n, h)[0]
    ref = k1.packed_stack_forward(**kw, approx=approx)
    rows, failures = [], []
    for level in (0, 1, 2):
        if k1.smem_bytes(n, h, level) > k1.MAX_SMEM:
            continue
        out = k1.packed_stack_forward(**kw, approx=approx, level=level)
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        ms = cuda_time(lambda: k1.packed_stack_forward(**kw, approx=approx,
                                                       level=level))
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


def random_batch(mols, n, b, gen):
    """b graphs cycling through `mols` in a bucket of n, at random
    positions (the K1 triu cases' batches)."""
    import torch

    from agdiff_torch.data.bucketing import pad_molecules

    batch = pad_molecules([mols[i % len(mols)] for i in range(b)], n,
                          device=gen.device)
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
    from agdiff_torch.sampling import graphed

    for m in mols:
        got = runner._engine_for(runner._bucket_for(m))
        if got != engine:
            raise SystemExit(f"{label}: engine {got!r}, expected {engine!r}")
    opts = engine_options(engine)
    name = k1.variant(opts.mode, opts.approx, opts.tight,
                      opts.mode == "full"
                      and runner.model_config.mlp_act == "gelu")
    fwd = runner.forward(engine)
    torch.cuda.synchronize()
    for c in kernel_counters().values():
        c.clear()
    calls0 = fwd.calls
    t0 = time.time()
    results = runner.run(mols, seed=SEED, num_confs=num_confs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    launches = counts.pop(f"stack_packed/{name}", 0)
    forwards = fwd.calls - calls0
    ranks = k1.last_launch.get("ranks")
    others = {k: c for k, c in counts.items()
              if k.startswith("stack_packed/") and c}
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
               k1_launches=launches, k1_ranks=ranks, wall_s=wall,
               ms_per_step=wall * 1e3 / forwards, conformers=n_conf,
               conformers_per_s=n_conf / wall)
    report["slices"][label] = row
    print(f"{label}: {engine}, buckets {row['buckets']}, atoms "
          f"{row['atoms']}, {num_confs} conformers each, {forwards} "
          f"forwards, K1 {name} launches {launches} (last at R={ranks}); "
          f"{row['ms_per_step']:.3f} ms/step, "
          f"{row['conformers_per_s']:.2f} conformers/s ({wall:.1f} s)",
          flush=True)
    return row


def profile_slice(fwd, diffusion, mol, bucket, chunk, label, report,
                  kernels, capacity=None, graph=False):
    """Where the time goes: torch.profiler over PROFILE_STEPS ladder steps
    of one chunk (`mol` repeated `chunk` times in `bucket`) on the forward
    `fwd`, with the pair list built once as the runner does (at
    `capacity` for a tight forward), eagerly or (`graph`) as replays of
    the ladder's CUDA graphs, captured by a first run outside the window.
    Reports the device's busy time (the union of kernel intervals), its
    idle share of the host-clock window, each hand kernel's share
    (`kernels`: label -> a substring of its name), and the kernels that
    took the most time; for graphs also the capture's seconds and, per
    hand kernel, the launches the window shows against those the replays
    ran (each graph's captured count times its replays)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.sampling.langevin import (
        SamplerConfig,
        build_fast_sampler,
    )

    dev = torch.device("cuda")
    sampler = build_fast_sampler(
        fwd, diffusion, SamplerConfig(n_steps=PROFILE_STEPS, w_global=0.3),
        pair_capacity=capacity, graph=graph)
    batch = pad_molecules([mol] * chunk, bucket, batch_size=chunk,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pos0 = torch.randn(batch.pos.shape, generator=gen, device=dev)
    sampler(batch, pos0, generator=gen)
    torch.cuda.synchronize()
    graphs = next(iter(sampler.ladders.values())) if graph else None
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
        return None
    busy, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    span = end - spans[0][0]   # the first kernel's start to the last end
    own = {k: sum(t for n, t in by_name.items() if sub in n)
           for k, sub in kernels.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = report["profiles"][label] = dict(
        steps=PROFILE_STEPS, batch=chunk, bucket=bucket, wall_us=wall_us,
        device_busy_us=busy, idle_share=1.0 - busy / wall_us,
        kernels_us=own, kernel_shares={k: t / busy for k, t in own.items()},
        kernels=len(spans), top=[dict(name=n[:80], us=t) for n, t in top],
        graph=graph, device_span_us=span, gap_share=1.0 - busy / span)
    if graph:
        seen = {k: sum(1 for _, _, n in spans if sub in n)
                for k, sub in kernels.items()}
        ran = {k: sum(graphs.captured[(kind, size)][0][name]
                      for kind, size, _, _ in graphs.ladder.plan
                      for name in graphs.captured[(kind, size)][0]
                      if name.startswith(KERNEL_COUNTERS[k]))
               for k in kernels}
        row.update(capture_s=graphs.capture_s, launches_seen=seen,
                   launches_replayed=ran, replays=len(graphs.ladder.plan))
        print(f"profile {label} (graphed): capture {graphs.capture_s:.3f} "
              f"s; hand-kernel launches in the window {seen}, run by "
              f"{len(graphs.ladder.plan)} replays {ran}; from the first "
              f"kernel's start to the last one's end {span / 1e3:.3f} ms, "
              f"idle between kernels there {1.0 - busy / span:.3f}",
              flush=True)
    shares = ", ".join(f"{k} {t / 1e3:.3f} ms = {t / busy:.3f}"
                       for k, t in own.items())
    print(f"profile {label}: {PROFILE_STEPS} steps of B={chunk} N={bucket}: "
          f"host window {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms (idle share {1.0 - busy / wall_us:.3f}); "
          f"of device time: {shares}; {len(spans)} kernels", flush=True)
    for n, t in top:
        print(f"  {t / 1e3:9.3f} ms  {n[:80]}", flush=True)
    return row


# ---- K2-K5 ------------------------------------------------------------------

PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
# Each new kernel against its plain version, per output, as shares of
# that output's max |plain value| (tests/test_torch_port_cuda.py holds the
# same). At f32 the two differ by summation order only; at bf16 a
# different f32 sum can flip the bf16 rounding of a hidden value (the
# filter's, K4's first layer's), which moves the outputs that use it.
# Each limit lies between the kernel's readings and the planted faults'
# (PERF.md).
F32_KERNEL_LIMITS = dict(max_rel=1e-5, median_rel=1e-6, p99_rel=5e-6,
                         beyond_1pct=0.0)
BF16_KERNEL_LIMITS = dict(max_rel=1e-2, median_rel=1e-6, p99_rel=3e-4,
                          beyond_1pct=1e-3)
OFF_MASK_LIMITS = dict(max_rel=0.0, median_rel=0.0, p99_rel=0.0,
                       beyond_1pct=0.0)
PATH_STEPS = 50         # paths A, B and D
SHORT_STEPS = 20        # paths C and D'


def kernel_counters() -> dict:
    """Every launch counter of the port, by kernel module, and the count
    of launches run by CUDA-graph replays."""
    from agdiff_torch.kernels import block_packed, fused, monolithic
    from agdiff_torch.kernels import stack_packed as k1
    from agdiff_torch.sampling import graphed

    return {"stack_packed": k1.launches, "fused": fused.launches,
            "block_packed": block_packed.launches,
            "monolithic": monolithic.launches, "captured": graphed.captured,
            "replayed": graphed.replayed}


def launch_counts() -> dict:
    """The launches by "<module>/<variant>": the wrappers' counts (eager
    launches, and a graph's launches once, at capture, where none runs)
    less the captured ones, plus each replay's captured count. For a
    graphed run this is what the captures recorded times the replays, not
    a count of what ran: phase 7's profiles of the replays are that."""
    from agdiff_torch.sampling import graphed

    out = (graphed.kernel_counts() + graphed.replayed) - graphed.captured
    return {k: n for k, n in out.items() if n}


def capture(fwd, batch, name, index=0):
    """The arguments of the first call (or the call `index`) of
    models/fast_forward.<name> (a kernel wrapper) while fwd runs on batch:
    the inputs that path gives that kernel."""
    from agdiff_torch.models import fast_forward as ff

    real, calls = getattr(ff, name), []

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(ff, name, record)
    try:
        fwd(batch)
    finally:
        setattr(ff, name, real)
    return calls[index]


def nbytes(*ts) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def conv_tensors(*convs):
    return [t for c in convs for t in (*c["fa"], *c["fb"], c["beta"])]


def filter_flops(c, f1, f2) -> int:
    """FLOPs of both filter MLPs on one row (pair)."""
    return 2 * (c * (f1 + f2) + f1 * f1 + f2 * f2)


def block_agg_work(args):
    e, w1, w2, h1, h2, c1, c2 = args
    b, n, _, c = e.shape
    f1, f2 = h1.shape[-1], h2.shape[-1]
    flops = b * n * n * (filter_flops(c, f1, f2) + 3 * (f1 + f2))
    io = nbytes(e, w1, w2, h1, h2, *conv_tensors(c1, c2)) \
        + 4 * b * n * (f1 + f2)
    return flops, io


def pair_score_work(args, dense=False):
    """(FLOPs, bytes) of K4 on these inputs: the products, both layers and
    the head on each masked pair (each pair of the N x N plane when
    `dense`, the count of the earlier bound), reading e only on those
    pairs, h, the mask and the weights once, and writing every output
    cell once."""
    h, e, mask, w1, b1, w2, b2, w3, b3 = args
    b, n, c = h.shape
    h1, h2 = w2.shape
    pairs = b * n * n if dense else int(mask.sum())
    flops = pairs * (c + 2 * (2 * c * h1 + h1 * h2) + 2 * h2)
    io = nbytes(h, mask, w1, b1, w2, b2, w3, b3) + 4 * b * n * n \
        + pairs * c * e.element_size()
    return flops, io


def gine_work(args):
    x, e, mask = args
    b, n, c = x.shape
    return 4 * b * n * n * c, nbytes(x, e, mask) + 4 * b * n * c


def packed_block_work(args):
    e, we1, we2, x1, x2, c1, c2, pairs = args
    b, p, c = e.shape
    n, f1, f2 = x1.shape[1], x1.shape[-1], x2.shape[-1]
    flops = b * p * (filter_flops(c, f1, f2) + 5 * (f1 + f2))
    io = nbytes(e, we1, we2, x1, x2, pairs.iu, pairs.ju,
                *conv_tensors(c1, c2)) + 4 * b * n * (f1 + f2)
    return flops, io


def check_kernel(label, name, kernel, plain, args, outputs, faults, limits,
                 work, peak, report, launch=None, levels=None) -> tuple:
    """A K2-K5 kernel against its plain version on a path's inputs:
    `outputs` lists (output name, index into the result, selection,
    scale-from output or None); each planted fault (name, plain-like
    callable) must break a limit; times and the bound. `launch` (K2, K3):
    returns the last launch's layout level and grid, printed beside the
    time; `levels` (K2, K3 at bf16): level -> a callable launching the
    kernel at that level, each of which must give the bits of the
    wrapper's choice (timed too). Returns the row and its failures."""
    import torch

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def rows(got, ref):
        table = {}
        for oname, k, sel, scale_of in outputs:
            scale = None
            if scale_of is not None:
                src = outputs[[o[0] for o in outputs].index(scale_of)]
                scale = float(ref[src[1]][src[2]].abs().max())
            table[oname] = errors(got[k], ref[k], sel, scale)
        return table

    got, again, ref = (as_tuple(kernel(*args)), as_tuple(kernel(*args)),
                       as_tuple(plain(*args)))
    torch.cuda.synchronize()
    outs = rows(got, ref)
    repro = all(torch.equal(g, a) for g, a in zip(got, again))
    fault_rows = {fname: rows(as_tuple(fn()), ref) for fname, fn in faults}
    ms = cuda_time(lambda: kernel(*args))
    ms_spun = cuda_time(lambda: kernel(*args), spin=True)
    info = launch() if launch else {}
    level_rows, level_failures = {}, []
    for lv, fn in (levels or {}).items():
        out = as_tuple(fn())
        torch.cuda.synchronize()
        same = all(torch.equal(g, o) for g, o in zip(got, out))
        level_rows[lv] = dict(same_bits=same, ms=cuda_time(fn))
        if not same:
            level_failures.append(f"{name} {label}: level {lv} differs from "
                                  f"level {info.get('level')}")
    plain_ms = cuda_time(lambda: plain(*args))
    flops, io = work(args)
    t_ops, t_bytes = flops / peak * 1e3, io / PEAK_BYTES * 1e3
    row = dict(case=label, variant=name, outputs=outs,
               limits={k: limits[k] for k in outs},
               planted_faults=fault_rows, bitwise_reproducible=repro,
               max_abs_err=max(r["max_abs_err"] for r in outs.values()),
               ms=ms, ms_spun=ms_spun, plain_ms=plain_ms, library_ms=None,
               flops=flops, launch=info, levels=level_rows,
               bytes=io, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    report["kernel_checks"].append(row)

    def line(table):
        return "; ".join(
            f"{o}: max {r['max_rel']:.3e} median {r['median_rel']:.3e} "
            f"p99 {r['p99_rel']:.3e} beyond-1% {r['beyond_1pct']:.3e} "
            f"(max|value| {r['max_abs_value']:.3e})"
            for o, r in table.items())

    print(f"{name} {label}: |kernel - plain| as shares of each output's "
          f"max|value|: {line(outs)}; two launches bitwise equal {repro}; "
          f"kernel {ms:.3f} ms (spun {ms_spun:.3f}), plain {plain_ms:.3f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops / 1e9:.2f} GFLOP, {io / 1e6:.1f} MB)"
          + (f"; layout level {info['level']}, grid {info['grid']}"
             if info else "")
          + "".join(f"; level {lv}: same bits {r['same_bits']}, "
                    f"{r['ms']:.3f} ms" for lv, r in level_rows.items()),
          flush=True)
    failures = [f"{name} {label}: kernel breaks {o} {k}"
                for o, k in broken_limits(outs, limits)] + level_failures
    if not repro:
        failures.append(f"{name} {label}: two launches differ")
    for fname, table in fault_rows.items():
        caught = broken_limits(table, limits)
        print(f"  planted fault '{fname}': {line(table)}; caught by "
              f"{caught}", flush=True)
        if not caught:
            failures.append(f"{name} {label}: the gate passes the planted "
                            f"fault '{fname}'")
    return row, failures


def no_bias(conv, key):
    import torch

    w, bias = conv[key]
    return dict(conv, **{key: (w, torch.zeros_like(bias))})


def shift_dropped(fn):
    """fn with the shifted softplus' '- ln 2' dropped (a planted fault)."""
    from agdiff_torch.kernels import fused

    def run():
        saved, fused.LN2 = fused.LN2, 0.0
        try:
            return fn()
        finally:
            fused.LN2 = saved
    return run


def last_pair_dropped(plain, mask):
    """plain() with each graph's last masked pair set to 0, as a kernel
    that drops the last entry of its list would leave it (a planted
    fault)."""
    def run():
        out = plain().clone()
        flat, m = out.view(out.shape[0], -1), mask.view(mask.shape[0], -1)
        last = m & (m.cumsum(1) == m.sum(1, keepdim=True))
        flat[last] = 0.0
        return out
    return run


def check_k4(label, fwd, batch, limits_for, report, failures,
             cases=("global", "local", "all_real", "global_spread")
             ) -> dict:
    """K4 on path `label`'s inputs at four masks: the global head's
    (the first call), the local head's (the second), every real-atom pair
    (i != j) on the global head's h and e, the worst case, and the global
    head's at positions spread MONO_POS_SCALE (as the ladder's top gives
    them, where the radius mask is sparse; at the batch's unit-scale
    positions every real pair is within the cutoff). Each mask's
    density and the bound over its pairs beside the dense count's bound;
    planted faults: the first-layer bias dropped, the mask ignored, each
    graph's last masked pair dropped, and with gelu heads relu in their
    place (the global head's inputs). `cases` picks masks. Returns the
    rows by name (the global head's under the variant's own name)."""
    import torch

    from agdiff_torch.kernels import fused

    rows = {}
    node = batch.node_mask
    real = (node[:, :, None] & node[:, None, :]
            & ~torch.eye(node.shape[1], dtype=torch.bool, device=node.device))
    glob = capture(fwd, batch, "pair_score_mlp")
    spread = batch.replace(pos=batch.pos * MONO_POS_SCALE)
    for case, (args, kw) in (
            ("global", glob),
            ("local", capture(fwd, batch, "pair_score_mlp", 1)),
            ("all_real", ((*glob[0][:2], real, *glob[0][3:]), glob[1])),
            ("global_spread", capture(fwd, spread, "pair_score_mlp"))):
        if case not in cases:
            continue
        h, e, mask, w1, b1, w2, b2, w3, b3 = args
        gelu = kw.get("activation") == "gelu"

        def kern(*a, kw=kw):
            return fused.pair_score_mlp(*a, **kw)

        def plain(*a, kw=kw):
            return fused.pair_score_mlp_plain(*a, **kw)

        outs = [("score", 0, mask, None), ("off_mask", 0, ~mask, "score")]
        faults = [
            ("first-layer bias dropped", lambda: plain(
                h, e, mask, w1, torch.zeros_like(b1), w2, b2, w3, b3)),
            ("mask ignored", lambda: plain(
                h, e, torch.ones_like(mask), w1, b1, w2, b2, w3, b3)),
            ("each graph's last masked pair dropped", last_pair_dropped(
                lambda: plain(*args), mask))]
        if gelu and case == "global":
            # on the global head's inputs the pre-activations sit near 0,
            # where gelu and relu differ; on the local head's most lie
            # past |x| ~ 5, where they agree to f32's last bits
            faults.append(("relu in place of gelu", lambda: plain(
                *args, kw={})))
        name = fused.variant("pair_score_gelu" if gelu else "pair_score",
                             h.dtype)
        peak = PEAK_F32 if h.dtype == torch.float32 else PEAK_BF16
        pairs, cells = int(mask.sum()), mask.numel()
        dense_flops, dense_io = pair_score_work(args, dense=True)
        dense_ms = max(dense_flops / peak, dense_io / PEAK_BYTES) * 1e3
        print(f"{name} path {label}, {case} mask: {pairs} of {cells} "
              f"ordered pairs (density {pairs / cells:.4f}; {int(real.sum())} "
              f"real pairs); bound over the masked pairs below, over all "
              f"N x N pairs {dense_ms:.4f} ms", flush=True)
        row, f = check_kernel(
            f"path {label} {case}", name, kern, plain, args, outs, faults,
            limits_for(("score", "off_mask"), h.dtype), pair_score_work,
            peak, report, launch=lambda name=name: fused.last_launch[name])
        row.update(mask_pairs=pairs, mask_cells=cells,
                   density=pairs / cells, dense_bound_ms=dense_ms)
        failures += f
        rows[name if case == "global" else f"{name} {case}"] = row
    return rows


def check_new_kernels(fwds, batch, report) -> tuple:
    """K3 (f32, bf16), K5, K4 (f32, bf16) and K2 (exact, '-approx') against
    their plain versions on the inputs of the paths' first call, with
    planted faults. `fwds`: the paths' forwards by name."""
    import torch

    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused

    node = batch.node_mask
    rows, failures = {}, []

    def limits_for(names, dtype):
        lim = (F32_KERNEL_LIMITS if dtype == torch.float32
               else BF16_KERNEL_LIMITS)
        return {n: (OFF_MASK_LIMITS if n == "off_mask" else lim)
                for n in names}

    for label, key in (("A", "pallas_f32"), ("B", "pallas_bf16")):
        args, _ = capture(fwds[key], batch, "interaction_block_aggregate")
        e, w1, w2, h1, h2, c1, c2 = args
        outs = [("agg1", 0, node, None), ("agg2", 1, node, None)]
        plain = fused.interaction_block_aggregate_plain
        faults = [
            ("filter bias dropped (conv 1)", lambda: plain(
                e, w1, w2, h1, h2, no_bias(c1, "fb"), c2)),
            ("softplus shift dropped", shift_dropped(lambda: plain(*args)))]
        name = fused.variant("block_agg", e.dtype)
        bf = e.dtype == torch.bfloat16
        rows[name], f = check_kernel(
            f"path {label}", name, fused.interaction_block_aggregate, plain,
            args, outs, faults, limits_for(("agg1", "agg2"), e.dtype),
            block_agg_work, PEAK_BF16 if bf else PEAK_F32, report,
            launch=lambda name=name: fused.last_launch[name],
            levels={lv: lambda args=args, lv=lv: fused.block_agg_launch(
                *args, level=lv) for lv in ((1,) if bf else (1, 2, 3))})
        failures += f

    args, _ = capture(fwds["pallas_f32"], batch, "gine_aggregate")
    x, e, mask = args
    plain = fused.gine_aggregate_plain
    faults = [
        ("mask ignored", lambda: plain(x, e, torch.ones_like(mask))),
        ("relu dropped", lambda: ((x[:, None] + e) * mask[..., None]
                                  .float()).sum(2))]
    rows["gine:f32"], f = check_kernel(
        "path A", "gine:f32", fused.gine_aggregate, plain, args,
        [("agg", 0, node, None)], faults,
        limits_for(("agg",), torch.float32), gine_work, PEAK_F32, report)
    failures += f
    row = rows["gine:f32"]
    row["ms_run"], row["host_ms_run"] = cuda_time_run(
        lambda: fused.gine_aggregate(*args))
    print(f"gine:f32 path A: {RUN_LAUNCHES} back-to-back launches, "
          f"{row['ms_run']:.4f} ms a launch (CUDA events over the run), "
          f"{row['bound_ms'] / row['ms_run']:.3f} of its bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); the host "
          f"launched one every {row['host_ms_run']:.4f} ms", flush=True)

    for label, key in (("C", "dense_f32"), ("C-bf16", "dense_bf16")):
        rows.update(check_k4(label, fwds[key], batch, limits_for, report,
                             failures))

    for label, key in (("D", "pk"), ("D'", "pk_approx")):
        args, kw = capture(fwds[key], batch, "packed_block_aggregate")
        e, we1, we2, x1, x2, c1, c2, pairs = args

        def kern(*a):
            return k2.packed_block_aggregate(*a, **kw)

        def plain(*a):
            return k2.packed_block_aggregate_plain(*a, **kw)

        outs = [("agg1", 0, node, None), ("agg2", 1, node, None)]
        faults = [
            ("filter bias dropped (conv 1)", lambda: plain(
                e, we1, we2, x1, x2, no_bias(c1, "fb"), c2, pairs)),
            ("softplus shift dropped", shift_dropped(lambda: plain(*args)))]
        name = k2.variant(e.dtype, kw.get("approx", False))
        rows[name], f = check_kernel(
            f"path {label}", name, kern, plain, args, outs, faults,
            limits_for(("agg1", "agg2"), e.dtype), packed_block_work,
            PEAK_BF16, report,
            launch=lambda name=name: k2.last_launch[name],
            levels={1: lambda args=args, kw=kw: k2.packed_block_launch(
                *args, level=1, **kw)})
        failures += f

    # K2's f32 variant (no engine runs it) on path D's inputs taken at f32
    args, _ = capture(fwds["pk"], batch, "packed_block_aggregate")
    args = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    e, we1, we2, x1, x2, c1, c2, pairs = args
    plain = k2.packed_block_aggregate_plain
    faults = [
        ("filter bias dropped (conv 1)", lambda: plain(
            e, we1, we2, x1, x2, no_bias(c1, "fb"), c2, pairs)),
        ("softplus shift dropped", shift_dropped(lambda: plain(*args)))]
    name = k2.variant(torch.float32, False)
    rows[name], f = check_kernel(
        "path D at f32", name, k2.packed_block_aggregate, plain, args,
        [("agg1", 0, node, None), ("agg2", 1, node, None)], faults,
        limits_for(("agg1", "agg2"), torch.float32), packed_block_work,
        PEAK_F32, report, launch=lambda: k2.last_launch[name])
    failures += f
    return rows, failures


def run_path(label, fwd, diffusion, mols, n_steps, per_forward, report,
             runner=None, num_confs=CHUNK) -> dict:
    """A path's ladder over `mols` (num_confs conformers each, bucket 32
    unless the runner picks another): through `runner` when given, else
    build_fast_sampler on `fwd`. Every
    launch count is set to 0 just before and read just after: each
    (counter, variant) of `per_forward` must have launched that many times
    per forward run (on graphed ladders: recorded at capture times the
    replays, launch_counts), and no other kernel at all; every position
    must be finite."""
    import numpy as np
    import torch

    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.sampling.langevin import (
        SamplerConfig,
        build_fast_sampler,
    )

    dev = fwd.schnet_emb.device
    buckets = (sorted({runner._bucket_for(m) for m in mols}) if runner
               else [32])
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.clear()
    calls0 = fwd.calls
    t0 = time.time()
    if runner is not None:
        done = runner.run(mols, seed=SEED, num_confs=num_confs)
        positions = [m.meta["pos_gen"] for m in done]
    else:
        sampler = build_fast_sampler(
            fwd, diffusion, SamplerConfig(n_steps=n_steps, w_global=0.3))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        positions = []
        for m in mols:
            batch = pad_molecules([m] * CHUNK, 32, batch_size=CHUNK,
                                  device=dev)
            pos0 = torch.randn(batch.pos.shape, generator=gen, device=dev)
            res = sampler(batch, pos0, generator=gen)
            positions.append(res.pos[:, :m.num_nodes].cpu().numpy())
    torch.cuda.synchronize()
    wall = time.time() - t0
    forwards = fwd.calls - calls0
    counts = launch_counts()
    want = {f"{mod}/{name}": k * forwards
            for (mod, name), k in per_forward.items()}
    for m, pg in zip(mols, positions):
        if pg.shape != (num_confs, m.num_nodes, 3):
            raise SystemExit(f"path {label}: bad conformer shape {pg.shape}")
        if not np.isfinite(pg).all():
            raise SystemExit(f"path {label}: non-finite conformer positions")
    if counts != want or forwards == 0:
        raise SystemExit(f"path {label}: launches {counts}, expected {want} "
                         f"for {forwards} forwards")
    n_conf = num_confs * len(mols)
    row = dict(steps=n_steps, forwards=forwards, launches=counts,
               wall_s=wall, ms_per_step=wall * 1e3 / forwards,
               conformers=n_conf, conformers_per_s=n_conf / wall,
               batch=num_confs, buckets=buckets)
    report["paths"][label] = row
    print(f"path {label}: {forwards} forwards of B={num_confs} N={buckets}, "
          f"launches "
          f"{counts}; {row['ms_per_step']:.3f} ms/step, "
          f"{row['conformers_per_s']:.2f} conformers/s ({wall:.1f} s)",
          flush=True)
    return row


# ---- K6 (engine 'mono') -----------------------------------------------------

# K6 against its plain version, per plane on its own mask (em for the
# global plane, lm for the local one), as shares of the plane's max |plain
# value| there; off the masks both must be exactly 0 (OFF_MASK_LIMITS).
# Each limit lies between the kernel's readings and the planted faults'
# (PERF.md). At f32 the two differ by summation order only. At bf16 a sum
# in another order can flip a bf16 rounding that later layers carry on.
# On the local plane at Drugs size (hl ~ 300, where one bf16 unit is 2)
# such a flip in a GIN message spreads through the node MLPs to every
# atom of its graph within a layer, so a graph with one flip differs
# everywhere and a graph with none agrees to f32 noise: the median there
# is that of the graphs that flipped. The plain version on the CPU differs
# from the one on the card the same way (check_k6 reads both), and the
# kernel gives the same bits at every layout level.
MONO_LIMITS = {
    "bf16": {"global": dict(max_rel=0.03, median_rel=1e-5, p99_rel=5e-3,
                            beyond_1pct=1e-3),
             "local": dict(max_rel=0.05, median_rel=1e-5, p99_rel=2e-2,
                           beyond_1pct=1e-2)},
    "bf16_drugs": {"global": dict(max_rel=0.03, median_rel=1e-4,
                                  p99_rel=5e-3, beyond_1pct=1e-3),
                   "local": dict(max_rel=0.25, median_rel=1e-2,
                                 p99_rel=0.1, beyond_1pct=0.4)},
    "f32": {"global": F32_KERNEL_LIMITS, "local": F32_KERNEL_LIMITS},
    # f32 at Drugs size: summation order only, but hl ~ 300 carries it
    # through four GIN layers (max 1.3e-5 of the local plane's largest)
    "f32_drugs": {"global": F32_KERNEL_LIMITS,
                  "local": dict(max_rel=5e-5, median_rel=5e-6, p99_rel=3e-5,
                                beyond_1pct=0.0)},
}
MONO_POS_SCALE = 6.0    # Angstrom: K6 cases' positions, N(0, 6^2) per axis,
# a noise level of the ladder at which pairs straddle the 10 A cutoff, so
# that the cutoff mask matters (at the ladder's top, sigma ~12, nearly
# every pair lies beyond it)
E_STEPS = 100           # path E
CLI_STEPS = 20


def mono_work(kw) -> tuple:
    """(FLOPs, bytes) K6 must do on these inputs: every product at 2 FLOPs
    per multiply-add, the elementwise message and sum work, the encoder,
    the distance weights, the filter MLPs, the messages and the global
    head over the pairs of the working graph (em = 1), the GIN messages
    and the local head over the bond pairs (lm = 1), the node side over
    all N nodes; each input read once and each output written once (the
    e32 scratch is K6's own)."""
    prm = kw["params"]
    b, p = kw["dp"].shape
    n, h = kw["h0"].shape[1:]
    nb, nl = prm.num_convs, prm.num_local
    dw = prm.w["c1_dw1k"].shape[1]
    f1, f2, r = h, h // 2, h // 16
    fw = f1 + f2
    pe, pl = float(kw["em"].sum()), float(kw["lm"].sum())
    enc = pe * 8 * h * h
    block = (pe * (4 * dw * 2 + 2 * (h * fw + f1 * f1 + f2 * f2) + 6 * fw)
             + b * 2 * n * (h * fw + f1 * h + f2 * h + 2 * h * h
                            + h * h // 2 + h // 2 + 2 * h * r))
    gin = b * 2 * n * h * h * 2 + pl * 2 * h * 3
    head = 2 * (h * h + h * h + h * h // 2 + h // 2) + h
    flops = enc + nb * block + nl * gin + (pe + pl) * head
    ins = [kw["dp"], kw["em"], kw["lm"], kw["tp"], kw["h0"], kw["hl0"],
           kw["pairs"].iu, kw["pairs"].ju, kw["pairs"].inc_ptr,
           kw["pairs"].inc]
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    nbytes += sum(t.numel() * t.element_size()
                  for t in prm._packed[kw["dp"].device])
    return flops, nbytes + 2 * b * p * 4


def mono_errors(got, ref, kw) -> dict:
    """Each plane on its mask, and every value off the masks (which must
    be 0), as shares of the global plane's scale."""
    import torch

    em, lm = kw["em"] > 0, kw["lm"] > 0
    rows = {"global": errors(got[0], ref[0], em),
            "local": errors(got[1], ref[1], lm)}
    off = torch.cat([got[0][~em], got[1][~lm]])
    rows["off_mask"] = errors(off, torch.zeros_like(off),
                              scale=rows["global"]["max_abs_value"])
    return rows


def mono_faults(kw) -> list:
    """Wrong versions of K6's function, each the plain version with one
    planted fault: (name, planes)."""
    import dataclasses
    import math

    import torch

    from agdiff_torch.kernels import monolithic as k6

    prm, plain = kw["params"], k6.mono_forward_plain
    row0 = {k: prm.w[k][:1].expand_as(prm.w[k]).contiguous()
            for k in ("table0", "table2")}

    def no_cutoff(d, cutoff, smooth):
        env = (0.5 * (torch.cos(d * math.pi / cutoff) + 1.0) if smooth
               else torch.exp(-((d - cutoff) ** 2) / (2 * cutoff ** 2)))
        return env * (d >= 0.0)

    def patched(name, value):
        saved = getattr(k6, name)
        setattr(k6, name, value)
        try:
            return plain(**kw)
        finally:
            setattr(k6, name, saved)

    # a compaction fault: each graph's last working pair left out
    em, lm = kw["em"].clone(), kw["lm"].clone()
    for g, keep in enumerate(k6.working_pairs(kw["em"], kw["lm"])):
        if len(keep):
            em[g, keep[-1]] = lm[g, keep[-1]] = 0.0
    gelu = [("relu heads in place of gelu", plain(**dict(
        kw, params=dataclasses.replace(prm, act="relu", _packed={},
                                       _scratch={}))))
            ] if prm.act == "gelu" else []
    return gelu + [
        ("type tables replaced by row 0", plain(**dict(
            kw, params=dataclasses.replace(prm, w={**prm.w, **row0},
                                           _packed={})))),
        ("cutoff mask dropped", patched("envelope", no_cutoff)),
        ("lm ignored", plain(**dict(kw, lm=torch.ones_like(kw["lm"])))),
        ("softplus shift dropped", patched("LN2", 0.0)),
        ("each graph's last working pair dropped",
         plain(**dict(kw, em=em, lm=lm))),
    ]


def check_k6(kw, label, limits, report, cpu_params=None) -> tuple:
    """K6 against its plain version on these inputs, plane by plane, two
    launches bitwise equal, every layout level that fits giving the bits
    of the wrapper's choice, the planted faults under the same limits, the
    times and the bound; with `cpu_params` (the same weights on the CPU)
    also the plain version on the CPU against the one on the card, for
    scale. Returns the case's row and its failures."""
    import torch

    from agdiff_torch.kernels import monolithic as k6

    def kernel():
        return k6.mono_forward(**kw)

    def plain():
        return k6.mono_forward_plain(**kw)

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    limits = dict(limits, off_mask=OFF_MASK_LIMITS)
    outs = mono_errors(got, ref, kw)
    repro = all(torch.equal(g, a) for g, a in zip(got, again))
    n, h = kw["h0"].shape[1:]
    itemsize = 2 if kw["params"].cd == torch.bfloat16 else 4
    levels, level_ms = {}, {}
    for lv in (0, 1, 2):
        if k6.smem_bytes(n, h, itemsize, lv) <= k6.MAX_SMEM:
            levels[lv] = all(torch.equal(g, a) for g, a in zip(
                got, k6.mono_forward(**kw, level=lv)))
            level_ms[lv] = cuda_time(
                lambda lv=lv: k6.mono_forward(**kw, level=lv))
    faults = {name: mono_errors(out, ref, kw)
              for name, out in mono_faults(kw)}
    ms, plain_ms = cuda_time(kernel), cuda_time(plain)
    ms_spun = cuda_time(kernel, spin=True)
    # the working lists K6 walks: pairs, 32-pair tiles (encoder, GIN,
    # heads) and, at bf16, 64-pair filter tiles (SchNet), over all graphs
    counts = [len(w) for w in k6.working_pairs(kw["em"], kw["lm"])]
    b, p = kw["dp"].shape
    walked = dict(pairs=sum(counts), share=sum(counts) / (b * p),
                  tiles32=sum(-(-c // 32) for c in counts),
                  tiles64=sum(-(-c // 64) for c in counts))
    cross = e32 = on_e32 = None
    if cpu_params is not None:   # after the timings
        on_cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items()}
        on_cpu.update(params=cpu_params, pairs=kw["pairs"].to("cpu"))
        cross = mono_errors(tuple(t.to(ref[0].device) for t in
                                  k6.mono_forward_plain(**on_cpu)), ref, kw)
        # where the difference starts: the encoder output the kernel's last
        # launch left in its scratch, against the plain encoder's, and the
        # kernel against the plain version fed the kernel's e32
        # (row r of a graph's scratch holds its r-th working pair; the
        # other pairs take the plain encoder's rows, which nothing reads)
        b, p = kw["dp"].shape
        h = kw["h0"].shape[2]
        rows = kw["params"].buffer(kw["dp"].device, "e32", 0)[
            :b * p * h * 4].view(torch.float32).view(b, p, h)
        e_plain = k6.encode_plain(kw["dp"], kw["tp"], kw["params"].w)
        e_k = e_plain.clone()
        for g, keep in enumerate(k6.working_pairs(kw["em"], kw["lm"])):
            e_k[g, keep] = rows[g, :len(keep)]
        work = (kw["em"] != 0) | (kw["lm"] != 0)
        e32 = errors(e_k[work], e_plain[work])
        saved, k6.encode_plain = k6.encode_plain, lambda *a: e_k
        try:
            on_e32 = mono_errors(got, k6.mono_forward_plain(**kw), kw)
        finally:
            k6.encode_plain = saved
    cd = kw["params"].cd
    flops, nbytes = mono_work(kw)
    peak = PEAK_BF16 if cd == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    b, p = kw["dp"].shape
    n, h = kw["h0"].shape[1:]
    row = dict(case=label, variant=k6.variant(cd, kw["params"].act), B=b,
               N=n, P=p,
               em_pairs=float(kw["em"].sum()), lm_pairs=float(
                   kw["lm"].sum()),
               layout_level=k6.layout(n, h, 2 if cd == torch.bfloat16
                                      else 4)[0],
               outputs=outs, limits=limits, planted_faults=faults,
               bitwise_reproducible=repro, levels_same_bits=levels,
               level_ms=level_ms, working=walked,
               plain_cpu_vs_plain=cross, e32_vs_plain=e32,
               kernel_vs_plain_on_kernel_e32=on_e32,
               max_abs_err=max(outs[k]["max_abs_err"]
                               for k in ("global", "local")),
               ms=ms, ms_spun=ms_spun, plain_ms=plain_ms, library_ms=None,
               flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    report["mono_checks"].append(row)

    def line(rows):
        return "; ".join(
            f"{name}: max {r['max_rel']:.3e} median {r['median_rel']:.3e} "
            f"p99 {r['p99_rel']:.3e} beyond-1% {r['beyond_1pct']:.3e} "
            f"(max|value| {r['max_abs_value']:.3e})"
            for name, r in rows.items())

    print(f"K6 {label} [{row['variant']}, layout {row['layout_level']}]: "
          f"B={b} N={n} P={p}, em pairs {row['em_pairs']:.0f}, lm pairs "
          f"{row['lm_pairs']:.0f}; working pairs {walked['pairs']} (share "
          f"{walked['share']:.4f} of the triangle), tiles walked "
          f"{walked['tiles32']} of 32 and {walked['tiles64']} of 64 pairs; "
          f"|kernel - plain| as shares of each "
          f"plane's max|value| on its mask: {line(outs)}; two launches "
          f"bitwise equal {repro}; kernel {ms:.3f} ms (spun {ms_spun:.3f}), "
          f"plain {plain_ms:.3f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); layout "
          f"levels giving the chosen level's bits: {levels}, their ms: "
          + ", ".join(f"{lv}: {t:.3f}" for lv, t in level_ms.items()),
          flush=True)
    if cross is not None:
        print(f"  plain version on the CPU vs on the card: {line(cross)}",
              flush=True)
        print(f"  e32, kernel vs plain: {line(dict(e32=e32))}; kernel vs "
              f"the plain version fed the kernel's e32: {line(on_e32)}",
              flush=True)
    failures = [f"K6 {label}: kernel breaks {o} {k}"
                for o, k in broken_limits(outs, limits)]
    if not repro:
        failures.append(f"K6 {label}: two launches differ")
    if not all(levels.values()):
        failures.append(f"K6 {label}: layout levels differ: {levels}")
    for name, rows in faults.items():
        caught = broken_limits(rows, limits)
        print(f"  planted fault '{name}': {line(rows)}; caught by "
              f"{caught}", flush=True)
        if not caught:
            failures.append(f"K6 {label}: the gate passes the planted fault "
                            f"'{name}'")
    return row, failures


def run_cli(model, cfg, mols, report) -> dict:
    """The generation CLI as a user runs it, in a subprocess: a reference
    .pt of `model` (the port's exporter) and `mols` as an .npz test set,
    engine 'mono', CLI_STEPS steps; then the same command again, which
    must resume: no molecule generated, no file rewritten."""
    import dataclasses

    import numpy as np
    import torch

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.eval.generate import load_samples
    from agdiff_torch.models.reference_checkpoint import (
        export_reference_state_dict,
    )

    root = os.path.join(OUT_DIR, "cli")
    ckpt = os.path.join(root, "ckpt", "model.pt")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({"model": export_reference_state_dict(model),
                "config": {"model": dataclasses.asdict(cfg)}}, ckpt)
    test_set = os.path.join(root, "qm9_fixture.npz")
    save_molecules(test_set, mols)
    out_dir = os.path.join(root, "samples_0")
    cmd = [sys.executable, "-m", "agdiff_torch.cli.generate", ckpt,
           "--test_set", test_set, "--fast", "--engine", "mono",
           "--n_steps", str(CLI_STEPS), "--chunk_size", str(CHUNK),
           "--w_global", "0.3", "--no_resume"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = []
    for argv in (cmd, cmd[:-1]):
        t0 = time.time()
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        runs.append(dict(rc=proc.returncode, wall_s=time.time() - t0,
                         generated=proc.stderr.count("samples generated")))
        if proc.returncode != 0:
            raise SystemExit(f"CLI exit {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
        if len(runs) == 1:
            stamps = {f: os.path.getmtime(os.path.join(out_dir, f))
                      for f in os.listdir(out_dir) if f.startswith("samples_")}
    done = load_samples(os.path.join(out_dir, "samples_all.npz"))
    for m, got in zip(mols, done):
        pg = got.meta["pos_gen"]
        if pg.shape != (2 * m.num_ref, m.num_nodes, 3) or \
                not np.isfinite(pg).all():
            raise SystemExit(f"CLI: bad samples {pg.shape}")
    rewritten = [f for f, t in stamps.items() if f != "samples_all.npz"
                 and os.path.getmtime(os.path.join(out_dir, f)) != t]
    if len(done) != len(mols) or runs[0]["generated"] != len(mols) \
            or runs[1]["generated"] or rewritten:
        raise SystemExit(f"CLI: {len(done)} molecules, runs {runs}, "
                         f"rewritten {rewritten}")
    row = dict(command=" ".join(cmd[1:]), runs=runs, molecules=len(done),
               conformers=[int(m.meta["pos_gen"].shape[0]) for m in done])
    report["cli"] = row
    print(f"CLI: {len(done)} molecules, {row['conformers']} conformers, "
          f"{CLI_STEPS} steps: first run {runs[0]['wall_s']:.1f} s "
          f"({runs[0]['generated']} generated), second run "
          f"{runs[1]['wall_s']:.1f} s ({runs[1]['generated']} generated, "
          f"resumed)", flush=True)
    return row


def graph_case(label, fwd, diffusion, batches, config, report,
               capacity=None) -> dict:
    """The same seed through one graphed sampler and the eager loop, for
    each batch in turn (a second graphed run of the first batch comes
    last when there are several): two eager runs, and two graphed runs,
    must give torch.equal positions, flags (and trajectory). Times one
    eager and one graphed run of each (the graphs captured before) per
    ladder step; records the NaN flags, the largest |position|, each
    ladder's memory pool and the peak device memory reserved."""
    import torch

    from agdiff_torch.sampling.langevin import build_fast_sampler

    graphed = build_fast_sampler(fwd, diffusion, config,
                                 pair_capacity=capacity)
    eager = build_fast_sampler(fwd, diffusion, config,
                               pair_capacity=capacity, graph=False)
    dev = batches[0].pos.device

    def run(sampler, batch):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        pos0 = torch.randn(batch.pos.shape, generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(batch, pos0, generator=gen)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / config.n_steps

    def same(a, b):
        return (torch.equal(a.pos, b.pos)
                and torch.equal(a.nan_flags, b.nan_flags)
                and (a.traj is None or torch.equal(a.traj, b.traj)))

    order = list(batches) + (list(batches[:1]) if len(batches) > 1 else [])
    rows, captures = [], []
    torch.cuda.empty_cache()   # the earlier cases' freed graphs and blocks
    torch.cuda.reset_peak_memory_stats(dev)
    for batch in order:
        e1, ms_e = run(eager, batch)
        e2, _ = run(eager, batch)
        g1, _ = run(graphed, batch)
        g2, ms_g = run(graphed, batch)
        if not same(e1, e2):
            raise SystemExit(f"graphs {label}: two eager runs differ")
        if not (same(g1, e1) and same(g2, e1)):
            rel = max(float((g.pos - e1.pos).abs().max()) for g in (g1, g2))
            raise SystemExit(f"graphs {label}: graphed and eager differ "
                             f"(max |difference| {rel:.3e})")
        (key, g), = [kg for kg in graphed.ladders.items()
                     if kg[0][0] == tuple(batch.pos.shape)]
        if not captures or captures[-1]["graphs"] is not g:
            captures.append(dict(graphs=g, key=str(key[2])[:60],
                                 capture_s=g.capture_s,
                                 pool_mb=g.pool_bytes / 2**20,
                                 blocks=sorted(f"{kind}:{size}" for kind, size
                                               in g.captured)))
        rows.append(dict(batch=tuple(batch.pos.shape), bitwise=True,
                         nan_flags=int(g1.nan_flags.sum()),
                         max_abs_pos=float(g1.pos.abs().max()),
                         ms_per_step_eager=ms_e, ms_per_step_graphed=ms_g,
                         traj=None if g1.traj is None
                         else tuple(g1.traj.shape)))
    for c in captures:
        del c["graphs"]
    row = dict(steps=config.n_steps, cases=rows, ladders=captures,
               ladders_kept=len(graphed.ladders),
               ms_per_step_eager=rows[0]["ms_per_step_eager"],
               ms_per_step_graphed=rows[0]["ms_per_step_graphed"],
               capture_s=captures[0]["capture_s"],
               max_reserved_mb=torch.cuda.max_memory_reserved(dev) / 2**20)
    report["graphs"][label] = row

    def case(r):
        return (f"B,N={r['batch'][:2]} bitwise, {r['nan_flags']} flagged, "
                f"max |pos| {r['max_abs_pos']:.3e}, "
                f"{r['ms_per_step_graphed']:.3f} ms/step graphed, "
                f"{r['ms_per_step_eager']:.3f} eager")

    print(f"graphs {label}: {config.n_steps} steps, "
          + "; ".join(case(r) for r in rows)
          + f"; {len(captures)} ladder(s) captured in "
          + ", ".join(f"{c['capture_s']:.3f} s ({c['pool_mb']:.1f} MiB "
                      f"pool)" for c in captures)
          + f", {row['ladders_kept']} kept; peak reserved "
          f"{row['max_reserved_mb']:.1f} MiB", flush=True)
    return row


def check_runner_warm(model, cfg, mols, report) -> dict:
    """GenerationRunner.warm on the QM9 fixtures, then the runner's samples
    against an eager runner's (graph=False): equal bit for bit."""
    import numpy as np
    import torch

    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    out, warmed = [], []
    dev = torch.device("cuda")
    for graph in (True, False):
        runner = GenerationRunner(
            model, cfg, make_diffusion(cfg),
            SamplerConfig(n_steps=GRAPH_STEPS, w_global=0.3), buckets=(32,),
            chunk_size=CHUNK, device=dev, graph=graph)
        t0 = time.perf_counter()
        warmed.append([w for m in mols for w in runner.warm(
            m, num_samples=CHUNK, retry=True)])
        if graph:
            warm_s = time.perf_counter() - t0
        out.append(runner.run(mols, seed=SEED, num_confs=CHUNK))
    same = all(np.array_equal(a.meta["pos_gen"], b.meta["pos_gen"])
               for a, b in zip(*out))
    if warmed[0] != [(32, CHUNK, False), (32, CHUNK, True)] or warmed[1] \
            or not same:
        raise SystemExit(f"runner after warm: captured {warmed}, samples "
                         f"equal to the eager runner's: {same}")
    row = dict(captured=warmed[0], warm_s=warm_s, bitwise=same,
               molecules=len(mols), conformers=CHUNK, steps=GRAPH_STEPS)
    report["graphs"]["runner"] = row
    print(f"graphs runner: warm captured {warmed[0]} in {warm_s:.3f} s; "
          f"{len(mols)} molecules x {CHUNK} conformers equal to the eager "
          f"runner's bit for bit", flush=True)
    return row


# ---- phase 7: the NaN guard ---------------------------------------------------

# the kernel wrappers the forwards call: (forward module, kernel module,
# wrapper); each kernel module holds the plain twin as <wrapper>_plain
TWINS = (("fast_forward", "stack_packed", "packed_stack_forward"),
         ("fast_forward", "fused", "interaction_block_aggregate"),
         ("fast_forward", "fused", "pair_score_mlp"),
         ("fast_forward", "fused", "gine_aggregate"),
         ("fast_forward", "block_packed", "packed_block_aggregate"),
         ("mono_forward", "monolithic", "mono_forward"))


def dropping_nan(plain):
    """A planted fault: `plain` with every relu it calls dropping NaN, as
    CUDA's fmaxf(x, 0.f) did in the kernels before (torch.nan_to_num
    after each relu; infinities kept)."""
    import torch

    def run(*args, **kw):
        relu = torch.relu
        torch.relu = lambda x: torch.nan_to_num(
            relu(x), nan=0.0, posinf=float("inf"), neginf=float("-inf"))
        try:
            return plain(*args, **kw)
        finally:
            torch.relu = relu
    return run


@contextlib.contextmanager
def plain_twins(drop_nan: bool = False):
    """The forwards call every kernel's plain twin, on the card, in place
    of its wrapper (which would launch the kernel); with drop_nan, the
    twins with the planted fault of `dropping_nan`."""
    import importlib

    saved = []
    try:
        for fwd_mod, kernel_mod, name in TWINS:
            fm = importlib.import_module(f"agdiff_torch.models.{fwd_mod}")
            km = importlib.import_module(f"agdiff_torch.kernels.{kernel_mod}")
            plain = getattr(km, name + "_plain")
            saved.append((fm, name, getattr(fm, name)))
            setattr(fm, name, dropping_nan(plain) if drop_nan else plain)
        yield
    finally:
        for fm, name, fn in saved:
            setattr(fm, name, fn)


def graph_flags(out) -> list:
    """Per graph: whether either score plane holds a non-finite value."""
    import torch

    planes = torch.stack([out.edge_inv_global.float(),
                          out.edge_inv_local.float()], 1)
    return (~torch.isfinite(planes)).flatten(1).any(1).tolist()


def nan_gate(label, fwd, diffusion, batch, config, report, capacity=None,
             relu=True) -> list:
    """For each of NAN_PLANTS (atom 0 of graph 1): one forward and one
    NAN_STEPS-step ladder (eager) through the hand kernels and through
    their plain twins on the card. The per-graph flags (non-finite score
    planes; the ladder's NaN flags) must be equal, with graph 1 flagged.
    The twins with their relus dropping NaN (plain_twins(drop_nan=True))
    must give other flags on some plant: a planted fault that must break
    the gate, on every path whose kernels hold a relu (relu=True; K2,
    path D's kernel, holds none). Returns the failures."""
    import torch

    from agdiff_torch.sampling.langevin import build_fast_sampler

    failures, rows, broken = [], {}, False
    for plant, value in NAN_PLANTS:
        pos = batch.pos.clone()
        pos[1, 0] = value
        planted = batch.replace(pos=pos)
        runs = {}
        for twin in ("kernel", "plain", "fault"):
            with (contextlib.nullcontext() if twin == "kernel"
                  else plain_twins(twin == "fault")):
                flags = graph_flags(fwd(planted))
                sampler = build_fast_sampler(fwd, diffusion, config,
                                             pair_capacity=capacity,
                                             graph=False)
                res = sampler(planted, pos, generator=torch.Generator(
                    device=pos.device).manual_seed(SEED))
                runs[twin] = (flags, res.nan_flags.tolist())
        kernel, plain, fault = (runs[k] for k in ("kernel", "plain", "fault"))
        ok = kernel == plain and kernel[0][1] and kernel[1][1]
        broken |= fault != plain
        rows[plant] = dict(
            equal=ok, forward_flagged=[k for k, f in enumerate(kernel[0])
                                       if f],
            ladder_flagged=[k for k, f in enumerate(kernel[1]) if f],
            fault_forward_flagged=[k for k, f in enumerate(fault[0]) if f],
            fault_ladder_flagged=[k for k, f in enumerate(fault[1]) if f])
        if not ok:
            failures.append(f"NaN gate {label} ({plant}): kernel flags "
                            f"{kernel}, plain twins' {plain}")
    if relu and not broken:
        failures.append(f"NaN gate {label}: the twins dropping NaN give the "
                        f"same flags (a planted fault that passes)")
    report.setdefault("nan_gate", {})[label] = dict(
        plants=rows, fault_breaks=broken, fault_applies=relu,
        steps=config.n_steps, batch=tuple(batch.pos.shape))
    print(f"NaN gate {label}: " + "; ".join(
        f"{p}: forward flags {r['forward_flagged']}, ladder flags "
        f"{r['ladder_flagged']}, kernel = plain {r['equal']}; NaN-dropping "
        f"twins flag {r['fault_forward_flagged']} / "
        f"{r['fault_ladder_flagged']}" for p, r in rows.items())
        + f"; the fault {'breaks' if broken else 'does not break'} it"
        + ("" if relu else " (no relu in this path's kernel)"), flush=True)
    return failures


def nan_off_mask(fwds, batch, report) -> list:
    """K4 (f32, bf16) and K5 on their first call's inputs (paths C and
    C-bf16), one edge feature on the mask and one off it NaN in graph 1:
    the kernel's non-finite elements are the plain twin's (K4: NaN on
    the mask, 0 off it, as the reference's where; K5: the reference
    applies the mask after the relu, so NaN off the mask reaches the
    sum); the twin with its relu dropping NaN must differ."""
    import torch

    from agdiff_torch.kernels import fused

    failures = []
    for label, fwd, name in (("K4 f32", fwds["dense_f32"], "pair_score_mlp"),
                             ("K4 bf16", fwds["dense_bf16"],
                              "pair_score_mlp"),
                             ("K5 f32", fwds["dense_f32"],
                              "gine_aggregate")):
        args, kw = capture(fwd, batch, name)
        args = list(args)
        e, mask, real = args[1].clone(), args[2], batch.node_mask[1]
        on = torch.nonzero(mask[1] & real[:, None] & real[None, :])[0]
        off = torch.nonzero(~mask[1] & real[:, None])[-1]
        e[1, on[0], on[1]] = e[1, off[0], off[1]] = float("nan")
        args[1] = e
        got = getattr(fused, name)(*args, **kw)
        ref = getattr(fused, name + "_plain")(*args, **kw)
        bad = dropping_nan(getattr(fused, name + "_plain"))(*args, **kw)
        torch.cuda.synchronize()
        same = torch.equal(~torch.isfinite(got), ~torch.isfinite(ref))
        if name == "pair_score_mlp":
            want = bool(torch.isnan(got[1, on[0], on[1]])) and \
                float(got[1, off[0], off[1]]) == 0.0
        else:
            want = bool(torch.isnan(got[1, off[0]]).all())
        fault = not torch.equal(~torch.isfinite(bad), ~torch.isfinite(ref))
        report.setdefault("nan_off_mask", {})[label] = dict(
            same_pattern=same, reference_semantics=want, fault_breaks=fault,
            non_finite=int((~torch.isfinite(got)).sum()))
        print(f"NaN off the mask {label}: kernel's non-finite elements the "
              f"plain twin's: {same} ({int((~torch.isfinite(got)).sum())}); "
              f"as the reference masks: {want}; NaN-dropping twin differs: "
              f"{fault}", flush=True)
        if not (same and want and fault):
            failures.append(f"NaN off the mask {label}: same {same}, "
                            f"reference semantics {want}, fault breaks "
                            f"{fault}")
    return failures


def runner_guard(label, runner, mols, num_confs, report) -> list:
    """A random-weight ladder through the runner (no clip_local): how many
    graphs its first ladder flagged, whether the clip_local retry ran,
    and no graph of the first ladder past OVERFLOW_POS unflagged (what
    NaN-dropping kernels gave: positions of 1e28-1e37 with no flag). Also
    counts the graphs past sigma_max x bucket, a box a sane ladder stays
    in."""
    import torch

    from agdiff_torch.eval.generate import RETRY_CLIP_LOCAL

    firsts, retries = [], []
    real = runner._sampler

    def spy(engine, retry, capacity=None):
        sampler = real(engine, retry, capacity)

        def run(batch, pos_init, generator=None):
            out = sampler(batch, pos_init, generator=generator)
            (retries if retry else firsts).append(
                (out, batch.node_mask, batch.pos.shape[1]))
            return out
        return run

    runner._sampler = spy
    try:
        t0 = time.time()
        runner.run(mols, seed=SEED, num_confs=num_confs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        del runner._sampler
    sigma_max = float(runner.diffusion.sigmas[-1])
    flagged = graphs = far = unflagged_far = boxed_out = 0
    worst = 0.0
    for out, mask, bucket in firsts:
        reach = (out.pos.abs().amax(-1) * mask).amax(-1)
        graphs += len(reach)
        flagged += int(out.nan_flags.sum())
        far += int((reach > OVERFLOW_POS).sum())
        unflagged_far += int(((reach > OVERFLOW_POS) & ~out.nan_flags).sum())
        boxed_out += int((reach > sigma_max * bucket).sum())
        if (~out.nan_flags).any():
            worst = max(worst, float(reach[~out.nan_flags].max()))
    row = dict(graphs=graphs, flagged=flagged, retry_ladders=len(retries),
               retry_clip_local=RETRY_CLIP_LOCAL, past_overflow=far,
               unflagged_past_overflow=unflagged_far,
               past_sigma_max_x_bucket=boxed_out,
               max_abs_pos_unflagged=worst, wall_s=wall,
               steps=runner.sampler_config.n_steps)
    report.setdefault("runner_guard", {})[label] = row
    print(f"runner guard {label}: {flagged} of {graphs} graphs flagged, "
          f"{len(retries)} clip_local={RETRY_CLIP_LOCAL:g} retry ladders; "
          f"{far} past {OVERFLOW_POS:g} A ({unflagged_far} unflagged), "
          f"{boxed_out} past sigma_max x bucket; largest |pos| of an "
          f"unflagged graph {worst:.3e} ({wall:.1f} s)", flush=True)
    failures = []
    if unflagged_far:
        failures.append(f"runner guard {label}: {unflagged_far} graphs past "
                        f"{OVERFLOW_POS:g} A not flagged")
    if flagged and not retries:
        failures.append(f"runner guard {label}: {flagged} flagged, no retry")
    return failures


# ---- phase 8: the test set ----------------------------------------------------

def test_sets():
    """QM9 size: SET_QM9 synthetic molecules of 9 heavy atoms (bench.py's
    QM9 row) with three reference conformers each; Drugs size: SET_DRUGS
    of 20 heavy atoms (bench.py's Drugs row), two pairs of one atom count
    each, so that packed chunks of the tight engine hold two molecules."""
    from agdiff_torch.data.synthetic import synthetic_dataset

    qm9 = synthetic_dataset(SET_QM9, seed=SEED, min_heavy=9, max_heavy=9,
                            num_conformers=3)
    by_size = {}
    for m in synthetic_dataset(6 * SET_DRUGS, seed=SEED, min_heavy=20,
                               max_heavy=20, num_conformers=3):
        by_size.setdefault(m.num_nodes, []).append(m)
    pairs = [ms[:2] for _, ms in sorted(by_size.items()) if len(ms) > 1]
    drugs = [m for pair in pairs[:SET_DRUGS // 2] for m in pair]
    return qm9, drugs


def generate_set(label, runner, mols, out_dir, report) -> dict:
    """runner.run over a test set into out_dir, K1's counts set to 0
    just before and read just after; conformers/s with the captures."""
    import numpy as np
    import torch

    for c in kernel_counters().values():
        c.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    out = runner.run(mols, out_dir, seed=SEED, resume=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1 = sum(n for k, n in launch_counts().items()
             if k.startswith("stack_packed/"))
    n_conf = sum(m.meta["pos_gen"].shape[0] for m in out)
    finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in out)
    row = dict(runner=type(runner).__name__, molecules=len(out),
               conformers=n_conf, wall_s=wall, conformers_per_s=n_conf / wall,
               k1_launches=k1, finite=finite,
               steps=runner.sampler_config.n_steps)
    report["test_set"]["runs"][label] = row
    print(f"test set {label}: {type(runner).__name__}, {len(out)} "
          f"molecules, {n_conf} conformers in {wall:.2f} s: "
          f"{row['conformers_per_s']:.2f} conformers/s "
          f"({row['steps']} steps, captures included; K1 launches {k1})",
          flush=True)
    return row


def start_scoring(samples):
    """`python -m agdiff_torch.cli.eval_covmat` on a samples file, in a
    subprocess started now (host only: it runs beside the card's work)."""
    return subprocess.Popen(
        [sys.executable, "-m", "agdiff_torch.cli.eval_covmat", samples,
         "--num_workers", "1"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT)), time.time()


def finish_scoring(label, started, samples, num_mols, report) -> list:
    """Each molecule's RMSD matrix natively and in numpy (equal to
    RMSD_PATHS_TOL), then the eval_covmat subprocess's scores: every
    molecule must survive the filter."""
    import numpy as np

    from agdiff_torch.chem.rmsd import rmsd_confusion_matrix
    from agdiff_torch.eval.generate import load_samples

    diff = 0.0
    for m in load_samples(samples):
        n = m.num_nodes
        refs = m.pos_ref.reshape(-1, n, 3)
        gens = m.meta["pos_gen"]
        diff = max(diff, float(np.abs(
            rmsd_confusion_matrix(m, refs, gens)
            - rmsd_confusion_matrix(m, refs, gens, use_native=False)).max()))
    proc, t0 = started
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"eval_covmat exit {proc.returncode}:\n{err[-3000:]}")
    wall = time.time() - t0
    with np.load(os.path.splitext(samples)[0] + "_covmat.npz") as res:
        covr, matr = res["CoverageR"], res["MatchingR"]
        thresholds = res["thresholds"]
    t = 0.5 if label.startswith("qm9") else 1.25   # the usual COV thresholds
    k = int(np.argmin(np.abs(thresholds - t)))
    row = dict(samples=os.path.relpath(samples, ROOT), molecules=num_mols,
               scored=int(covr.shape[0]), cov_r_at=float(thresholds[k]),
               cov_r_mean=float(covr[:, k].mean()) if len(covr) else None,
               mat_r_mean=float(matr.mean()) if len(matr) else None,
               native_vs_numpy_max=diff, eval_wall_s=wall,
               weights="random")
    report["test_set"]["scores"][label] = row
    print(f"COV/MAT {label} (random weights; says nothing of quality): "
          f"{row['scored']} of {num_mols} molecules scored, COV-R at "
          f"{row['cov_r_at']:.2f} A {row['cov_r_mean']}, MAT-R "
          f"{row['mat_r_mean']} A; native against numpy RMSD max |diff| "
          f"{diff:.3e}; eval_covmat {wall:.1f} s (beside other work)",
          flush=True)
    failures = []
    if row["scored"] != num_mols:
        failures.append(f"COV/MAT {label}: {row['scored']} of {num_mols} "
                        f"molecules survive the filter")
    if not diff <= RMSD_PATHS_TOL:
        failures.append(f"COV/MAT {label}: native and numpy RMSD differ by "
                        f"{diff:.3e}")
    return failures


def packed_against_alone(label, runner_of, mols, tol, report) -> list:
    """Strided DDIM at eta 0 (no noise), item seeds: molecule 0 with
    molecule 1's samples (4 + 4 slots: the batch size of molecule 0
    alone, 4 slots, both 8) gives its samples alone bit for bit; the
    whole set packed (6 samples each: other batch sizes) gives each
    molecule's samples alone within `tol`
    (the engine's limit against f32: 5% at QM9 size, 15% at Drugs size)
    of their largest coordinate. Samples the guard zeroed (all 0) are
    counted; every molecule needs some that are not."""
    import numpy as np

    seeds = [(SEED + 1, i) for i in range(len(mols))]
    runner = runner_of()

    def run(ms, confs, idx):
        return runner.run(ms, None, num_confs=confs,
                          item_seeds=[seeds[i] for i in idx])

    alone4 = run(mols[:1], [4], [0])[0].meta["pos_gen"]
    pair = run(mols[:2], [4, 4], [0, 1])[0].meta["pos_gen"]
    bitwise = bool(np.array_equal(pair, alone4))
    everything = run(mols, [6] * len(mols), range(len(mols)))
    rels, zeroed, scales = [], 0, []
    for i, m in enumerate(everything):
        alone = run(mols[i:i + 1], [6], [i])[0].meta["pos_gen"]
        zeroed += int((np.abs(alone).reshape(len(alone), -1).max(1) == 0)
                      .sum())
        scales.append(float(np.abs(alone).max()))
        rels.append(float(np.abs(m.meta["pos_gen"] - alone).max())
                    / scales[-1])
    worst = float(np.max(rels))   # NaN if any is
    row = dict(bitwise_same_batch=bitwise, max_rel_other_batch=worst,
               tol=tol, steps=DDIM_STEPS, zeroed_samples=zeroed,
               min_scale=min(scales))
    report["test_set"]["packed_vs_alone"][label] = row
    print(f"packed against alone {label} (DDIM eta 0, {DDIM_STEPS} strided "
          f"steps, item seeds): same batch size bit for bit {bitwise}; "
          f"other batch sizes max |diff| {worst:.3e} of the largest "
          f"coordinate (limit {tol}); {zeroed} of {6 * len(mols)} samples "
          f"alone zeroed by the guard, least scale {min(scales):.3e} A",
          flush=True)
    failures = []
    if not bitwise:
        failures.append(f"packed against alone {label}: not bit for bit at "
                        f"one batch size")
    if not worst <= tol or not min(scales) > 0:
        failures.append(f"packed against alone {label}: {worst:.3e} > "
                        f"{tol} or a molecule's samples all zeroed")
    return failures


def run_test_set(qmodel, qcfg, dmodel, dconf, report, dev) -> list:
    """Phase 8: the QM9- and Drugs-size test sets through
    GenerationRunner and PackedGenerationRunner (the QM9 one also as the
    CLI's --packed, in a subprocess), scored through cli.eval_covmat in
    subprocesses that run while the card checks packed against alone."""
    import dataclasses as dc

    import torch

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.eval.generate import (
        GenerationRunner,
        PackedGenerationRunner,
    )
    from agdiff_torch.models.reference_checkpoint import (
        export_reference_state_dict,
    )
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    report["test_set"] = {"runs": {}, "scores": {}, "packed_vs_alone": {}}
    root = os.path.join(OUT_DIR, "test_set")
    qm9, drugs = test_sets()
    ladder = SamplerConfig(n_steps=SET_STEPS, w_global=0.3,
                           global_start_sigma=0.5, clip_local=20.0)
    ddim = dc.replace(ladder, n_steps=DDIM_STEPS, ladder="strided",
                      sampling_type="generalized", eta=0.0)
    failures = []
    sets = (("qm9", qm9, qmodel, qcfg, (32,), CHUNK, ENGINE_TOL),
            ("drugs", drugs, dmodel, dconf.model, dconf.buckets,
             DRUGS_CHUNK, DRUGS_ENGINE_TOL))
    scoring, later = [], []
    for name, mols, model, cfg, buckets, chunk, tol in sets:
        report["test_set"][name] = dict(
            atoms=[m.num_nodes for m in mols], refs=[m.num_ref for m in mols])

        def runner(cls, scfg, model=model, cfg=cfg, buckets=buckets,
                   chunk=chunk):
            return cls(model, cfg, make_diffusion(cfg), scfg,
                       buckets=buckets, chunk_size=chunk, device=dev)

        solo = generate_set(f"{name}_solo", runner(GenerationRunner, ladder),
                            mols, os.path.join(root, f"{name}_solo"), report)
        packed = generate_set(
            f"{name}_packed", runner(PackedGenerationRunner, ladder), mols,
            os.path.join(root, f"{name}_packed"), report)
        for row in (solo, packed):
            if not (row["finite"] and row["k1_launches"]):
                failures.append(f"test set {name}: {row}")
        samples = os.path.join(root, f"{name}_packed", "samples_all.npz")
        if name == "qm9":   # the same run as a user starts it
            ckpt = os.path.join(root, "ckpt", "model.pt")
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
            torch.save({"model": export_reference_state_dict(model),
                        "config": {"model": dc.asdict(cfg)}}, ckpt)
            test_set = os.path.join(root, "qm9.npz")
            save_molecules(test_set, mols)
            out_dir = os.path.join(root, "qm9_cli")
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "agdiff_torch.cli.generate", ckpt,
                 "--test_set", test_set, "--fast", "--packed", "--n_steps",
                 str(SET_STEPS), "--chunk_size", str(chunk), "--w_global",
                 "0.3", "--clip_local", "20", "--seed", str(SEED),
                 "--out_dir", out_dir, "--no_resume", "--device",
                 dev.type],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"CLI --packed exit {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
            report["test_set"]["cli_packed_s"] = time.time() - t0
            print(f"test set qm9: cli.generate --packed in "
                  f"{time.time() - t0:.1f} s", flush=True)
            samples = os.path.join(out_dir, "samples_all.npz")
        scoring.append((name, samples, len(mols)))
        later.append((name, functools.partial(
            runner, PackedGenerationRunner, ddim), mols, tol))
    # scored on the host while the card runs the checks below
    scoring = [(name, start_scoring(samples), samples, num_mols)
               for name, samples, num_mols in scoring]
    for name, runner_of, mols, tol in later:
        failures += packed_against_alone(name, runner_of, mols, tol, report)
    for name, started, samples, num_mols in scoring:
        failures += finish_scoring(name, started, samples, num_mols, report)
    return failures


# ---- phase 9: training --------------------------------------------------------

TRAIN_CONFIG = "synthetic_qm9.yml"   # hidden 128, 6 + 4 convs, B=64, f32
TRAIN_MOLECULES = 512   # synthetic_dataset(512, seed=2021), split 0.9 / 0.1
# phase 9 runs a third of its first iterations (300, 200 and 100 at
# first), phase 11 two thirds (192 and 64), as later phases joined the run:
# the gates are the same, and the whole script stays inside its time limit
# on a slower host
TRAIN_ITERS = 100
TRAIN_VAL_FREQ = 50     # validations and checkpoints at 50 and 100
RESUME_FROM = 50        # 50 resumed iterations against the same of the run
PACKED_ITERS = 25
TRAIN_EMA = 0.999
LOSS_WINDOW = 50        # the last 50 losses' mean below the first 50's
# eager train and distill steps timed, then profiled (20 at first; 5 keep
# the run inside its time limit as later phases join it)
TRAIN_PROFILE_STEPS = 5
TRAIN_GEN_MOLS = 4      # held-out: the generation CLI's synthetic seed 7
# the Trainer's loss history: 2 x LOSS_LOG_FREQ + 1 iterations, so that the
# last one is pending when train() returns, then as many again
LOSS_LOG_FREQ = 5
LOSS_ITERS = 2 * LOSS_LOG_FREQ + 1
TRAIN_GEN_STEPS = 50
# One train step on the card against the same step on the CPU (f32, the
# same init_like_jax weights, batch, timesteps and noise; TF32 off), each
# quantity on its own scale: the three losses relative to themselves;
# each gradient leaf as shares of max(its max |g|, GRAD_NOISE x the
# model's largest |g|) (leaves whose true gradient is 0, the biases ahead
# of a BatchNorm, hold rounding noise only), the worst leaf's max, median
# and p99; each running statistic as a share of its max; the parameters
# after the optimizer step: the share of elements whose update differs by
# more than 1% of the learning rate, among those whose CPU gradient
# exceeds UPDATE_FLOOR x the largest |g| (Adam's first step moves each
# element by about lr times the sign of its gradient, so an element whose
# gradient is rounding noise may move either way). The same limits hold
# packed_pairs against dense on the card.
GRAD_NOISE = 1e-3
UPDATE_FLOOR = 1e-5
STEP_LIMITS = dict(loss_rel=1e-5, grad_max_rel=1e-3, grad_median_rel=1e-5,
                   grad_p99_rel=1e-4, stats_max_rel=1e-5,
                   update_off_share=1e-4)
TRAIN_FAULTS = ("bn_eval_in_train", "unbiased_normaliser",
                "local_weight_1", "local_in_global_mask")


@contextlib.contextmanager
def train_fault(name):
    """A planted fault in the train step: BatchNorm left in eval mode
    while training; the unbiased variance normalising; the local loss
    weight 5 made 1; ~local dropped from the global edge mask."""
    from agdiff_torch.models import loss
    from agdiff_torch.nn import common
    from agdiff_torch.ops import masked

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "bn_eval_in_train":
        real = common.MaskedBatchNorm.forward
        patch(common.MaskedBatchNorm, "forward",
              lambda self, x, mask, train=False: real(self, x, mask, False))
    elif name == "unbiased_normaliser":
        real = masked.masked_batch_norm_stats

        def unbiased(x, mask, group=None):
            mean, var, count = real(x, mask, group=group)
            return mean, var * count / (count - 1.0), count
        patch(masked, "masked_batch_norm_stats", unbiased)
    elif name == "local_weight_1":
        patch(loss, "LOCAL_WEIGHT", 1.0)
    elif name == "local_in_global_mask":
        patch(loss, "global_edge_mask",
              lambda d, local, em, cutoff: ((d <= cutoff) | local) & em)
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def train_step_on(config, module, device, batch, t, noise):
    """One train step of `module` (moved to `device`) on the injected t and
    noise: (metrics, {name: grad}, {name: buffer}, {name: param before},
    {name: param after}), all on the CPU."""
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState, make_train_step

    import torch

    module = module.to(device)
    state = TrainState(step=0, module=module,
                       optimizer=make_optimizer(module, config.train),
                       generator=torch.Generator(device=device))
    before = {n: p.detach().cpu().clone()
              for n, p in module.named_parameters()}
    m = make_train_step(config, device)(state, batch.to(device),
                                        t.to(device), noise.to(device))
    return step_result(m, module, before)


def step_result(metrics, module, before):
    """(metrics as floats, {name: grad}, {name: buffer}, before, {name:
    param after}) on the CPU; a parameter a planted fault leaves without
    a gradient has a zero one."""
    import torch

    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().cpu() for n, p in module.named_parameters()}
    after = {n: p.detach().cpu() for n, p in module.named_parameters()}
    bufs = {n: b.detach().cpu() for n, b in module.named_buffers()}
    return ({k: float(v) for k, v in metrics._asdict().items()}, grads,
            bufs, before, after)


def step_errors(got, ref, lr) -> dict:
    """The card step `got` against the CPU step `ref` (train_step_on's
    tuples), on the scales STEP_LIMITS names."""
    import torch

    mg, gg, bg, _, ag = got
    mr, gr, br, pr, ar = ref
    loss_rel = max(abs(mg[k] - mr[k]) / abs(mr[k])
                   for k in ("loss", "loss_global", "loss_local") if k in mr)
    top = max(float(g.abs().max()) for g in gr.values())
    worst = {"grad_max_rel": (0.0, ""), "grad_median_rel": (0.0, ""),
             "grad_p99_rel": (0.0, "")}
    for name, g in gr.items():
        scale = max(float(g.abs().max()), GRAD_NOISE * top)
        e = errors(gg[name], g, scale=scale)
        if not e["finite"]:
            e = dict(max_rel=float("inf"), median_rel=float("inf"),
                     p99_rel=float("inf"))
        for key, stat in (("grad_max_rel", "max_rel"),
                          ("grad_median_rel", "median_rel"),
                          ("grad_p99_rel", "p99_rel")):
            if e[stat] >= worst[key][0]:
                worst[key] = (e[stat], name)
    stats = max((errors(bg[n], b, scale=max(float(b.abs().max()), 1e-30))
                 ["max_rel"] for n, b in br.items()), default=0.0)
    off = total = 0
    for name, p0 in pr.items():
        real = gr[name].abs() > UPDATE_FLOOR * top
        d = ((ag[name] - p0) - (ar[name] - p0)).abs()[real]
        off += int((~(d <= 0.01 * lr)).sum())
        total += d.numel()
    row = dict(loss_rel=loss_rel, stats_max_rel=stats,
               update_off_share=off / max(total, 1), grad_top=top,
               loss=mg["loss"], loss_ref=mr["loss"])
    for key, (v, name) in worst.items():
        row[key], row[key + "_leaf"] = v, name
    row["broken"] = [k for k, lim in STEP_LIMITS.items()
                     if not row[k] <= lim]
    return row


def train_batch(config, mols):
    """The loader's first batch (bucket 32, B = 64) of the training split,
    and the injected timesteps and noise."""
    import torch

    from agdiff_torch.data.dataset import BucketedLoader, ConformationDataset
    from agdiff_torch.models.loss import sample_timesteps

    loader = BucketedLoader(ConformationDataset(mols),
                            config.train.batch_size, config.buckets,
                            edge_order=config.model.edge_order,
                            seed=config.train.seed)
    _, batch = loader.next_batch()
    gen = torch.Generator().manual_seed(SEED)
    t = sample_timesteps(gen, batch.num_graphs,
                         config.model.num_diffusion_timesteps)
    noise = torch.randn(batch.pos.shape, generator=gen)
    return batch, t, noise


def check_train_step(config, mols, dev, report, title="train step",
                     key="step_checks") -> list:
    """The card step against the CPU step, the planted faults, and the
    packed_pairs layout against the dense one on the card; the rows go to
    report["train"][key]."""
    import copy

    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_like_jax

    failures = []
    batch, t, noise = train_batch(config, mols)
    init = init_like_jax(DualEncoderEpsNetwork(config.model),
                         torch.Generator().manual_seed(config.train.seed))
    lr = config.train.optimizer.lr
    t0 = time.time()
    ref = train_step_on(config, copy.deepcopy(init), torch.device("cpu"),
                        batch, t, noise)
    cpu_s = time.time() - t0
    rows = {"card_vs_cpu": step_errors(
        train_step_on(config, copy.deepcopy(init), dev, batch, t, noise),
        ref, lr)}
    for name in TRAIN_FAULTS:
        with train_fault(name):
            rows[f"fault {name}"] = step_errors(train_step_on(
                config, copy.deepcopy(init), dev, batch, t, noise), ref, lr)
    packed_cfg = dataclasses.replace(config, model=dataclasses.replace(
        config.model, packed_pairs=True))
    dense = train_step_on(config, copy.deepcopy(init), dev, batch, t, noise)
    packed_init = DualEncoderEpsNetwork(packed_cfg.model)
    packed_init.load_state_dict(init.state_dict())
    rows["packed_vs_dense"] = step_errors(train_step_on(
        packed_cfg, packed_init, dev, batch, t, noise), dense, lr)
    report["train"][key] = rows
    nodes = int((batch.node_mask & batch.graph_mask[:, None]).sum())
    print(f"{title}: B={batch.num_graphs} N={batch.node_mask.shape[1]} "
          f"({nodes} real nodes), loss {ref[0]['loss']:.4f} on the CPU "
          f"({cpu_s:.1f} s), limits {STEP_LIMITS}", flush=True)
    for label, row in rows.items():
        print(f"  {label}: loss {row['loss_rel']:.2e}, grads max "
              f"{row['grad_max_rel']:.2e} ({row['grad_max_rel_leaf']}), "
              f"median {row['grad_median_rel']:.2e}, p99 "
              f"{row['grad_p99_rel']:.2e}, stats {row['stats_max_rel']:.2e},"
              f" updates off {row['update_off_share']:.2e}; broken "
              f"{row['broken']}", flush=True)
        fault = label.startswith("fault")
        if fault and not row["broken"]:
            failures.append(f"{title}: {label} breaks no limit")
        if not fault and row["broken"]:
            failures.append(f"{title}: {label} breaks {row['broken']}")
    return failures


def profile_train(label, config, mols, dev, report) -> dict:
    """TRAIN_PROFILE_STEPS steps of a fresh model on one batch
    (profile_steps)."""
    from agdiff_torch.train.train_step import (
        create_train_state,
        make_train_step,
    )

    batch = train_batch(config, mols)[0].to(dev)
    state = create_train_state(config, dev)
    step = make_train_step(config, dev)
    return profile_steps(f"train profile {label}", report["train"]
                         ["profiles"], label, lambda: step(state, batch),
                         batch)


def profile_steps(title, section, label, step_once, batch) -> dict:
    """TRAIN_PROFILE_STEPS calls of `step_once` (an eager train or
    distill step on `batch`) after three of warm-up: ms per step (CUDA
    events), peak device memory of a step, and a profile of the steps:
    device busy (the union of kernel intervals), idle share of the host
    window, and the device operations that took the most time. The row
    goes to section[label]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step_once()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_PROFILE_STEPS):
        step_once()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_PROFILE_STEPS
    peak = torch.cuda.max_memory_allocated()
    # device activity only: the host's ~5000 ops a step would cost the
    # profiler's post-processing far more than the steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            step_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    row = dict(steps=TRAIN_PROFILE_STEPS, batch=batch.num_graphs,
               bucket=batch.node_mask.shape[1], ms_per_step=ms,
               it_per_s=1000.0 / ms, peak_mib=peak / 2 ** 20,
               peak_over_state_mib=(peak - base) / 2 ** 20, wall_us=wall_us)
    if spans:
        busy, last = 0.0, float("-inf")
        by_name = {}
        for s, e, name in spans:
            busy += max(0.0, e - max(s, last))
            last = max(last, e)
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        row.update(device_busy_us=busy, idle_share=1.0 - busy / wall_us,
                   kernels=len(spans),
                   top=[dict(name=n[:80], us=u) for n, u in top])
    section[label] = row
    busy_txt = (f"device busy {row['device_busy_us'] / 1e3:.3f} ms of a "
                f"{wall_us / 1e3:.3f} ms host window (idle share "
                f"{row['idle_share']:.3f}), {row['kernels']} kernels"
                if spans else "the profiler recorded no device kernels: "
                "device busy not measured")
    print(f"{title}: {TRAIN_PROFILE_STEPS} steps of "
          f"B={row['batch']} N={row['bucket']}: {ms:.3f} ms/step "
          f"({row['it_per_s']:.2f} it/s), peak {row['peak_mib']:.0f} MiB "
          f"({row['peak_over_state_mib']:.0f} over the state); {busy_txt}",
          flush=True)
    for item in row.get("top", []):
        print(f"  {item['us'] / 1e3:9.3f} ms  {item['name']}", flush=True)
    return row


def write_train_config(path, model=None, **changes):
    """configs/synthetic_qm9.yml with the train section's `changes`, the
    model section's `packed_pairs` when given and the model fields of
    `model`."""
    import yaml

    with open(os.path.join(ROOT, "configs", TRAIN_CONFIG)) as f:
        raw = yaml.safe_load(f)
    packed = changes.pop("packed_pairs", False)
    raw["train"].update(changes)
    raw["model"]["packed_pairs"] = packed
    raw["model"].update(model or {})
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def same_checkpoint(a, b) -> list:
    """The entries of two checkpoints' state that are not torch.equal."""
    import torch

    bad = [f"module.{k}" for k in a["module"]
           if not torch.equal(a["module"][k].cpu(), b["module"][k].cpu())]
    bad += [f"ema.{k}" for k in a["ema"]
            if not torch.equal(a["ema"][k].cpu(), b["ema"][k].cpu())]
    for part, oa in a["optimizer"]["adams"].items():
        ob = b["optimizer"]["adams"][part]
        if oa["count"] != ob["count"] or not all(
                torch.equal(x.cpu(), y.cpu())
                for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"])):
            bad.append(f"optimizer.{part}")
    if not torch.equal(a["generator"], b["generator"]):
        bad.append("generator")
    if a["loader"]["rng"] != b["loader"]["rng"] \
            or a["loader"]["cursor"] != b["loader"]["cursor"]:
        bad.append("loader")
    return bad


def tensorboard_against_metrics(log_dir) -> list:
    """The differences between a run's TensorBoard events and its
    metrics.jsonl: the same tags at the same steps, each event the JSONL
    value rounded to float32."""
    import numpy as np
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir)
    acc.Reload()
    events = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
              for tag in acc.Tags()["scalars"]}
    want = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in map(json.loads, f):
            for tag, value in line.items():
                if tag != "step":
                    want.setdefault(tag, []).append(
                        (line["step"], float(np.float32(value))))
    return [f"{tag}: events {events.get(tag)}, metrics.jsonl {want.get(tag)}"
            for tag in sorted(set(events) | set(want))
            if events.get(tag) != want.get(tag)]


def check_loss_history(config, train_mols, dev, root, report) -> list:
    """Phase 9 (a): a Trainer on the card for LOSS_ITERS iterations holds
    at most LOSS_LOG_FREQ of the step's loss tensors at a log point and
    none but the last step's once train() returns; LOSS_ITERS more leave
    torch.cuda.memory_allocated() as it was. (b) whether its TensorBoard
    writer is active here, and if it is, its events against
    metrics.jsonl."""
    import weakref

    import torch

    from agdiff_torch.data.dataset import ConformationDataset
    from agdiff_torch.train.trainer import Trainer
    from agdiff_torch.utils.logging import TensorBoardWriter

    failures = []
    log_dir = os.path.join(root, "loss_history")
    t0 = time.time()
    trainer = Trainer(config, ConformationDataset(train_mols), None, log_dir,
                      device=dev, log_freq=LOSS_LOG_FREQ)
    refs, alive_at_logs = [], []
    step, log = trainer.train_step, trainer._log

    def recording_step(state, batch):
        metrics = step(state, batch)
        refs.append(weakref.ref(metrics.loss))
        return metrics

    def recording_log(*args):
        alive_at_logs.append(sum(r() is not None for r in refs))
        log(*args)

    trainer.train_step, trainer._log = recording_step, recording_log
    trainer.train(max_iters=LOSS_ITERS)
    alive = [i + 1 for i, r in enumerate(refs) if r() is not None]
    torch.cuda.synchronize()
    mem_n = torch.cuda.memory_allocated(dev)
    trainer.start_iter = LOSS_ITERS + 1
    trainer.train(max_iters=2 * LOSS_ITERS)
    torch.cuda.synchronize()
    mem_2n = torch.cuda.memory_allocated(dev)
    losses = trainer.losses
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        logged = {line["step"]: line["train/loss"]
                  for line in map(json.loads, f)}
    tb = next(w for w in trainer.writer.writers
              if isinstance(w, TensorBoardWriter))
    tb_diff = tensorboard_against_metrics(log_dir) if tb.active else []
    row = dict(log_freq=LOSS_LOG_FREQ, iterations=LOSS_ITERS,
               alive_at_logs=alive_at_logs, alive_after=alive,
               memory_allocated=[mem_n, mem_2n],
               tensorboard_active=tb.active, tensorboard_diff=tb_diff[:5],
               wall_s=time.time() - t0)
    report["train"]["loss_history"] = row
    print(f"train loss history: a Trainer on the card, {LOSS_ITERS} "
          f"iterations at log_freq {LOSS_LOG_FREQ}: the step's loss tensors "
          f"alive at its log points {alive_at_logs}, after train() "
          f"{len(alive)} (iterations {alive}); "
          f"torch.cuda.memory_allocated() {mem_n} B after {LOSS_ITERS} "
          f"iterations, {mem_2n} B after {2 * LOSS_ITERS}; "
          f"{row['wall_s']:.1f} s", flush=True)
    print(f"train TensorBoard on the card: active {tb.active} ("
          + ("its events against metrics.jsonl: "
             f"{'equal' if not tb_diff else tb_diff[:3]}" if tb.active else
             "torch.utils.tensorboard does not import here: metrics.jsonl "
             "only") + ")", flush=True)
    if max(alive_at_logs, default=0) > LOSS_LOG_FREQ or alive:
        failures.append(f"train loss history: tensors alive at log points "
                        f"{alive_at_logs}, after train() {alive}")
    if mem_n != mem_2n:
        failures.append(f"train loss history: memory_allocated {mem_n} B "
                        f"after {LOSS_ITERS} iterations, {mem_2n} B after "
                        f"{2 * LOSS_ITERS}")
    if len(losses) != 2 * LOSS_ITERS or any(
            losses[it - 1] != v for it, v in logged.items()):
        failures.append(f"train loss history: {len(losses)} losses, logged "
                        f"{logged}")
    if tb_diff:
        failures.append(f"train TensorBoard: {tb_diff[:3]}")
    return failures


def run_training(dev, report) -> list:
    """Phase 9: the card step against the CPU step (and its planted
    faults, and packed against dense), the Trainer through cli/train.py
    (dense, then packed_pairs), a resume, the trained checkpoint through
    cli/generate.py and cli/eval_covmat.py, and a profile of train steps."""
    import shutil

    import numpy as np
    import torch

    from agdiff_torch.cli import generate as gen_cli
    from agdiff_torch.cli import train as train_cli
    from agdiff_torch.config import load_config
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.eval.generate import load_samples
    from agdiff_torch.train.checkpoint import load_checkpoint

    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("train: float32 products must be full float32 "
                         "(TF32 off) before the train gate")
    report["train"] = {"profiles": {}}
    failures = []
    config = load_config(os.path.join(ROOT, "configs", TRAIN_CONFIG))
    mols = synthetic_dataset(TRAIN_MOLECULES, seed=config.train.seed)
    train_mols = mols[:max(1, int(len(mols) * 0.9))]
    failures += check_train_step(config, train_mols, dev, report)

    root = os.path.join(OUT_DIR, "train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    synth = ["--synthetic", str(TRAIN_MOLECULES), "--deterministic",
             "--device", str(dev)]
    dense_cfg = write_train_config(
        os.path.join(root, "dense.yml"), max_iters=TRAIN_ITERS,
        val_freq=TRAIN_VAL_FREQ, ema_decay=TRAIN_EMA)
    try:
        t0 = time.time()
        full = train_cli.main([dense_cfg, "--logdir",
                               os.path.join(root, "logs"), *synth])
        dense_s = time.time() - t0
        resumed_dir = os.path.join(root, "resumed")
        shutil.copytree(full.log_dir, resumed_dir)
        shutil.rmtree(os.path.join(resumed_dir, "checkpoints",
                                   str(TRAIN_ITERS)))
        t0 = time.time()
        resumed = train_cli.main([resumed_dir, "--resume_iter",
                                  str(RESUME_FROM), *synth])
        resume_s = time.time() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    losses = np.asarray(full.losses)
    first, last = (float(losses[:LOSS_WINDOW].mean()),
                   float(losses[-LOSS_WINDOW:].mean()))
    if len(losses) != TRAIN_ITERS or not np.isfinite(losses).all():
        failures.append(f"train: {len(losses)} losses, finite "
                        f"{bool(np.isfinite(losses).all())}")
    if not last < first:
        failures.append(f"train: the last {LOSS_WINDOW} losses' mean "
                        f"{last:.4f} is not below the first's {first:.4f}")
    ckpt = lambda d: load_checkpoint(os.path.join(
        d, "checkpoints", str(TRAIN_ITERS)))
    bad = same_checkpoint(ckpt(full.log_dir), ckpt(resumed_dir))
    same_losses = resumed.losses == full.losses[RESUME_FROM:]
    if bad or not same_losses:
        failures.append(f"train resume: iterations {RESUME_FROM + 1}-"
                        f"{TRAIN_ITERS} differ from the uninterrupted run "
                        f"(losses equal {same_losses}; {bad[:5]})")
    report["train"]["dense_run"] = dict(
        iterations=TRAIN_ITERS, wall_s=dense_s, it_per_s=TRAIN_ITERS / dense_s,
        loss_first=first, loss_last=last, loss_min=float(losses.min()),
        resume_wall_s=resume_s, resumed_equal=not bad and same_losses,
        log_dir=os.path.relpath(full.log_dir, ROOT))
    print(f"train dense: {TRAIN_ITERS} iterations through cli/train.py in "
          f"{dense_s:.1f} s ({TRAIN_ITERS / dense_s:.2f} it/s with loader, "
          f"{TRAIN_ITERS // TRAIN_VAL_FREQ + 1} validations and checkpoints,"
          f" deterministic algorithms); loss mean of the first "
          f"{LOSS_WINDOW} {first:.4f}, of the last {last:.4f}; resumed from "
          f"{RESUME_FROM}: {TRAIN_ITERS - RESUME_FROM} iterations in "
          f"{resume_s:.1f} s, torch.equal to the run: {not bad} (losses "
          f"{same_losses})", flush=True)

    packed_cfg = write_train_config(
        os.path.join(root, "packed.yml"), max_iters=PACKED_ITERS,
        val_freq=PACKED_ITERS, packed_pairs=True)
    t0 = time.time()
    packed = train_cli.main([packed_cfg, "--logdir",
                             os.path.join(root, "logs_packed"), "--synthetic",
                             str(TRAIN_MOLECULES), "--device", str(dev)])
    packed_s = time.time() - t0
    plosses = np.asarray(packed.losses)
    if len(plosses) != PACKED_ITERS or not np.isfinite(plosses).all():
        failures.append(f"train packed: {len(plosses)} losses, finite "
                        f"{bool(np.isfinite(plosses).all())}")
    report["train"]["packed_run"] = dict(
        iterations=PACKED_ITERS, wall_s=packed_s,
        it_per_s=PACKED_ITERS / packed_s, loss_first=float(plosses[0]),
        loss_last=float(plosses[-1]))
    print(f"train packed_pairs: {PACKED_ITERS} iterations in {packed_s:.1f} "
          f"s ({PACKED_ITERS / packed_s:.2f} it/s with loader), losses "
          f"finite {bool(np.isfinite(plosses).all())}", flush=True)
    failures += check_loss_history(config, train_mols, dev, root, report)

    # the trained checkpoint (the EMA shadow) to generated, scored samples
    out = os.path.join(root, "samples")
    torch.cuda.synchronize()
    for c in kernel_counters().values():
        c.clear()
    t0 = time.time()
    gen_cli.main([full.log_dir, "--ema", "--synthetic", str(TRAIN_GEN_MOLS),
                  "--end_idx", str(TRAIN_GEN_MOLS), "--n_steps",
                  str(TRAIN_GEN_STEPS), "--fast", "--engine", "pksf",
                  "--w_global", "0.3", "--out_dir", out, "--no_resume",
                  "--device", str(dev)])
    gen_s = time.time() - t0
    k1_runs = sum(n for k, n in launch_counts().items()
                  if k.startswith("stack_packed/"))
    samples = os.path.join(out, "samples_all.npz")
    done = load_samples(samples)
    proc = subprocess.run(
        [sys.executable, "-m", "agdiff_torch.cli.eval_covmat", samples,
         "--num_workers", "2"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"eval_covmat exit {proc.returncode}:\n"
                         f"{proc.stderr[-3000:]}")
    with np.load(os.path.splitext(samples)[0] + "_covmat.npz") as res:
        covr, matr, thr = res["CoverageR"], res["MatchingR"], \
            res["thresholds"]
    k = int(np.argmin(np.abs(thr - 0.5)))
    finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in done)
    gen_row = dict(molecules=len(done), steps=TRAIN_GEN_STEPS, wall_s=gen_s,
                   k1_launches=k1_runs, finite=finite,
                   scored=int(covr.shape[0]),
                   cov_r_at=float(thr[k]), cov_r_mean=float(covr[:, k].mean())
                   if len(covr) else None,
                   mat_r_mean=float(matr.mean()) if len(matr) else None)
    report["train"]["generated"] = gen_row
    print(f"train -> generate: the EMA weights of iteration {TRAIN_ITERS}, "
          f"{len(done)} held-out molecules, {TRAIN_GEN_STEPS} 'pksf' steps "
          f"in {gen_s:.1f} s (K1 launches {k1_runs}), finite {finite}; "
          f"COV-R at {gen_row['cov_r_at']:.2f} A {gen_row['cov_r_mean']}, "
          f"MAT-R {gen_row['mat_r_mean']} A ({gen_row['scored']} scored; "
          f"{TRAIN_ITERS} iterations of training say little of quality)",
          flush=True)
    if len(done) != TRAIN_GEN_MOLS or not finite or not k1_runs \
            or gen_row["scored"] != TRAIN_GEN_MOLS:
        failures.append(f"train -> generate: {gen_row}")

    for label, cfg in (("dense", config), ("packed", dataclasses.replace(
            config, model=dataclasses.replace(config.model,
                                              packed_pairs=True)))):
        profile_train(label, cfg, train_mols, dev, report)
    # the checkpoints (tens of MB each) are not kept; the logs are
    for d, subdirs, _ in os.walk(root):
        if "checkpoints" in subdirs:
            shutil.rmtree(os.path.join(d, "checkpoints"))
    p = report["train"]["profiles"]
    print(f"train: dense {p['dense']['it_per_s']:.2f} it/s "
          f"({p['dense']['ms_per_step']:.3f} ms/step, peak "
          f"{p['dense']['peak_mib']:.0f} MiB), packed "
          f"{p['packed']['it_per_s']:.2f} it/s "
          f"({p['packed']['ms_per_step']:.3f} ms/step, peak "
          f"{p['packed']['peak_mib']:.0f} MiB) at B={p['dense']['batch']} "
          f"N={p['dense']['bucket']}; loss "
          f"{first:.3f} -> {last:.3f} over {TRAIN_ITERS} iterations; "
          f"resume bit for bit {report['train']['dense_run']['resumed_equal']}"
          f"; generated MAT-R {gen_row['mat_r_mean']} A "
          f"({report['card']})", flush=True)
    return failures


# ---- phase 10: the generation server ---------------------------------------

# the servers' ladder: strided DDIM at eta 0 (noise-free, so a merged
# request can be held against its solo run), clip_local 20 and w_global
# 0.3 (bench.py's settings for random weights), SERVE_STEPS steps
SERVE_STEPS = 50
SERVE_WINDOW = 0.5      # s: requests merged within it (--batch_window)
SERVE_CHUNK = 64        # the CLI's default chunk
SERVE_CONFS = 8         # conformers a molecule a request
SERVE_REQUESTS = 6      # concurrent QM9 requests of two molecules each
# merged against alone across batch sizes, from a server's replies after
# GROWTH_STEPS steps: a forward at another batch size differs in the last
# bits (not through K1's R: at R = 1 for every size the reading is the
# same) and the random-weight ladder multiplies that ~10x a step (4.4e-7,
# 9.9e-2, 1.81 of the largest coordinate after 2, 8, 50 steps on the
# H100, PERF.md); the limit lies between that (0.099) and a request given
# another request's seeds (0.99)
GROWTH_STEPS = DDIM_STEPS
GROWTH_LIMIT = 0.3
ENGINE_STEPS = 10       # each Part B engine through GenerationRunner (20
# to PR 15)
# the engines of JAX's XLA path (no hand kernel) and the '-e16' forms:
# (label, engine, config key, tolerance against f32)
PHASE10_ENGINES = (
    ("slim", "slim", "qm9", 0.05), ("slim8", "slim8", "qm9", 0.05),
    ("approx", "approx", "qm9", 0.05), ("pksf-e16", "pksf-e16", "qm9", 0.05),
    ("stack", "stack", "qm9_f32", F32_ENGINE_TOL),
    ("tight-slim", "tight-slim", "drugs", DRUGS_ENGINE_TOL),
    ("tight-slim8", "tight-slim8", "drugs", DRUGS_ENGINE_TOL),
    ("tight-approx", "tight-approx", "drugs", DRUGS_ENGINE_TOL),
    ("tight-pksf-e16", "tight-pksf-e16", "drugs", DRUGS_ENGINE_TOL))


def serve_ladder(n_steps=None):
    from agdiff_torch.sampling.langevin import SamplerConfig

    return SamplerConfig(n_steps=n_steps or SERVE_STEPS, ladder="strided",
                         sampling_type="generalized", eta=0.0,
                         clip_local=20.0, w_global=0.3)


def start_service(runner, max_nodes):
    """GenerationService.serve on a daemon thread, merging within
    SERVE_WINDOW: (service, port, thread)."""
    import threading

    from agdiff_torch.serve.server import GenerationService

    svc = GenerationService(runner, batch_window_s=SERVE_WINDOW,
                            max_nodes=max_nodes)
    box, ready = [], threading.Event()
    thread = threading.Thread(target=svc.serve, daemon=True, kwargs=dict(
        port=0, ready_callback=lambda p: (box.append(p), ready.set())))
    thread.start()
    if not ready.wait(60):
        raise SystemExit("serve: the server did not start")
    return svc, box[0], thread


def stop_service(runner, port, thread):
    """Shut the server down and give its graphs' memory back."""
    import torch

    from agdiff_torch.serve.server import submit

    reply = submit({"cmd": "shutdown"}, port=port, timeout=60)
    thread.join(timeout=120)
    for s in runner._samplers.values():
        s.release()
    torch.cuda.empty_cache()
    return reply.get("shutdown") is True and not thread.is_alive()


def burst(port, requests):
    """Each request from its own client thread at once: [(reply, latency
    s)] in the requests' order, and the burst's wall seconds."""
    import threading

    from agdiff_torch.serve.server import submit

    out = [None] * len(requests)

    def client(i):
        t0 = time.time()
        out[i] = (submit(requests[i], port=port, timeout=600),
                  time.time() - t0)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(requests))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, time.time() - t0


def device_counts(fwd):
    """(launches by kernel variant, forwards run, ladders captured) since
    the counters were last set to 0."""
    from agdiff_torch.sampling.graphed import LadderGraphs

    return launch_counts(), fwd.calls, LadderGraphs.captures


def zero_counts():
    for c in kernel_counters().values():
        c.clear()


def serve_qm9(qmodel, qcfg, qmols, dmols, dev, report) -> list:
    """(a) A QM9 server in this process: PackedGenerationRunner on
    qm9_fast.yml ('pksf'), warmed for the fixture molecules' sizes at
    every batch size with the retry's ladders; SERVE_REQUESTS concurrent
    requests of two molecules x SERVE_CONFS conformers; each merged
    request against its "batch": false run; a molecule above max_nodes
    rejected while the request merged with it is answered; a saved
    request scored by "evaluate"."""
    import numpy as np
    import torch

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.serve.server import submit

    root = os.path.join(OUT_DIR, "serve")
    os.makedirs(root, exist_ok=True)
    sets = []
    for k in range(2):
        path = os.path.join(root, f"qm9_{k}.npz")
        save_molecules(path, qmols[2 * k:2 * k + 2])
        sets.append(path)
    over_set = os.path.join(root, "drugs_one.npz")
    save_molecules(over_set, dmols[:1])
    runner = PackedGenerationRunner(
        qmodel, qcfg, make_diffusion(qcfg), serve_ladder(), buckets=(32,),
        chunk_size=SERVE_CHUNK, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    svc, port, thread = start_service(runner, max_nodes=32)
    t0 = time.time()
    warm = submit({"cmd": "warm", "retry": True,
                   "nodes": sorted({m.num_nodes for m in qmols})},
                  port=port, timeout=600)
    warm_s = time.time() - t0
    pools = runner.warmed_pool_bytes()
    fwd = runner.forward("pksf")

    def request(i, **kw):
        return {"cmd": "generate", "test_set": sets[i % 2],
                "num_confs": SERVE_CONFS, "seed": 100 + i, "save": False,
                "return_pos": True, **kw}

    torch.cuda.synchronize(dev)
    zero_counts()
    calls0, captures0 = fwd.calls, device_counts(fwd)[2]
    replies, wall = burst(port, [request(i) for i in range(SERVE_REQUESTS)])
    counts, calls, captures = device_counts(fwd)
    forwards = calls - calls0
    k1 = counts.pop("stack_packed/stack_full:triu", 0)
    latencies = sorted(lat for _, lat in replies)
    conformers = sum(r["samples"] for r, _ in replies if r.get("ok"))
    failures = []
    if not all(r.get("ok") for r, _ in replies):
        failures.append(f"serve QM9: a request failed: "
                        f"{[r for r, _ in replies if not r.get('ok')]}")
    merged = sum(1 for r, _ in replies if r.get("batched_with", 0) >= 1)
    if merged < 2:
        failures.append(f"serve QM9: {merged} requests merged, need 2")
    if k1 != forwards or not k1 or counts:
        failures.append(f"serve QM9: K1 launches {k1}, forwards "
                        f"{forwards}, other kernels {counts}")
    if captures != captures0:
        failures.append(f"serve QM9: {captures - captures0} ladders "
                        f"captured during requests")
    # each merged request: against the packed runner run directly on the
    # merged set (bit for bit: the server adds nothing), and against its
    # solo run (bit for bit where the chunk's batch size is the same)
    order = sorted(range(SERVE_REQUESTS), key=lambda i: 100 + i)
    merged_mols = [m for i in order for m in qmols[2 * (i % 2):
                                                   2 * (i % 2) + 2]]
    with svc.device_lock:
        direct = runner.run(merged_mols, None, num_confs=[SERVE_CONFS] * len(
            merged_mols), item_seeds=[(100 + i, k) for i in order
                                      for k in range(2)], save=False,
            resume=False)
    direct_same = all(
        np.array_equal(np.asarray(p, np.float32),
                       direct[2 * order.index(i) + k].meta["pos_gen"])
        for i, (r, _) in enumerate(replies) if r.get("ok")
        for k, p in enumerate(r["pos"]))
    if not direct_same:
        failures.append("serve QM9: merged replies differ from the packed "
                        "runner's run of the same set")
    solo_rows, solo_lat = [], []

    def against_alone(i, r, alone):
        """One merged reply against its solo reply: the batch sizes of
        their chunks, bit for bit, max |diff| of the largest coordinate."""
        got = [np.asarray(p, np.float32) for p in r["pos"]]
        want = [np.asarray(p, np.float32) for p in alone["pos"]]
        scale = max(float(np.abs(w).max()) for w in want)
        rel = max(float(np.abs(g - w).max())
                  for g, w in zip(got, want)) / max(scale, 1e-30)
        n = r["samples"]
        same = runner._batch_size_for(n) == runner._batch_size_for(min(
            n * (r["batched_with"] + 1), SERVE_CHUNK)) or n >= SERVE_CHUNK
        solo_rows.append(dict(request=i, batched_with=r["batched_with"],
                              samples=n, same_batch=same,
                              bitwise=all(np.array_equal(g, w)
                                          for g, w in zip(got, want)),
                              max_rel=rel, scale=scale,
                              finite=all(np.isfinite(g).all() for g in got)))
        return solo_rows[-1]

    for i, (r, _) in enumerate(replies):
        t1 = time.time()
        alone = submit(request(i, batch=False), port=port, timeout=600)
        solo_lat.append(time.time() - t1)
        if r.get("ok") and alone.get("ok"):
            row = against_alone(i, r, alone)
            if not row["finite"]:
                failures.append(f"serve QM9: request {i} not finite")
    # requests of one chunk each (2 molecules x 32 conformers): merged,
    # each chunk is one request's, at its solo batch size
    whole = [request(10 + k, num_confs=SERVE_CHUNK // 2) for k in range(2)]
    pair = [r for r, _ in burst(port, whole)[0]]
    for k, r in enumerate(pair):
        alone = submit({**whole[k], "batch": False}, port=port, timeout=600)
        if not (r.get("ok") and alone.get("ok") and r["batched_with"] >= 1):
            failures.append(f"serve QM9: one-chunk requests {r}, {alone}")
            continue
        row = against_alone(10 + k, r, alone)
        if not (row["same_batch"] and row["bitwise"]):
            failures.append(f"serve QM9: one-chunk request {k} merged "
                            f"against alone {row}")
    captures_after_solo = device_counts(fwd)[2]
    # over capacity, merged with a request that must be answered
    (over, _), (ok, _) = burst(port, [
        {"cmd": "generate", "test_set": over_set, "num_confs": SERVE_CONFS,
         "save": False, "seed": 1},
        request(0)])[0]
    if over.get("rejected") != "over_capacity" or "Traceback" in \
            over.get("error", "") or not ok.get("ok"):
        failures.append(f"serve QM9: over capacity {over}, merged {ok}")
    saved = submit({**request(1, batch=False), "num_confs": "2x",
                    "save": True, "return_pos": False,
                    "out_dir": os.path.join(root, "saved")}, port=port,
                   timeout=600)
    scored = submit({"cmd": "evaluate", "samples": saved.get("out"),
                     "num_workers": 4}, port=port, timeout=600)
    if not (saved.get("ok") and scored.get("ok")
            and scored.get("molecules") == 2):
        failures.append(f"serve QM9: saved {saved}, evaluate {scored}")
    ping = submit({"cmd": "ping"}, port=port, timeout=60)
    if captures_after_solo != captures0 or \
            device_counts(fwd)[2] != captures0:
        failures.append("serve QM9: ladders captured after warm-up")
    peak = torch.cuda.max_memory_reserved(dev)
    if not stop_service(runner, port, thread):
        failures.append("serve QM9: shutdown")
    growth = serve_growth(qmodel, qcfg, qmols, sets, dev)
    if not (growth["merged"] and growth["other_batch_size"] <= GROWTH_LIMIT
            < growth["swapped_seeds"]):
        failures.append(f"serve QM9: merged against alone at other batch "
                        f"sizes after {GROWTH_STEPS} steps {growth} (limit "
                        f"{GROWTH_LIMIT}: the sound runs within it, the "
                        f"swapped seeds beyond it)")
    row = dict(
        warm_s=warm_s, warmed_ladders=len(warm.get("compiled", [])),
        warm_reply_ok=warm.get("ok"), pools_mib=pools / 2 ** 20,
        peak_reserved_mib=peak / 2 ** 20, requests=SERVE_REQUESTS,
        conformers=conformers, burst_s=wall,
        conformers_per_s=conformers / wall,
        latency_p50_s=statistics.median(latencies),
        latency_max_s=latencies[-1], solo_latency_s=solo_lat,
        merged=merged, forwards=forwards, k1_launches=k1,
        ladders_captured_during_requests=captures_after_solo - captures0,
        merged_vs_solo=solo_rows, merged_equals_runner=direct_same,
        growth=growth, over_capacity=over.get("error"),
        evaluate=scored, cached_programs=ping.get("cached_programs"))
    report["serve"]["qm9"] = row
    same = [s for s in solo_rows if s["same_batch"]]
    other = [s["max_rel"] for s in solo_rows if not s["same_batch"]]
    print(f"serve QM9 ('pksf', chunk {SERVE_CHUNK}, {SERVE_STEPS} strided "
          f"DDIM steps at eta 0): warm-up {warm_s:.2f} s, "
          f"{row['warmed_ladders']} ladders, pools {row['pools_mib']:.1f} "
          f"MiB; {SERVE_REQUESTS} concurrent requests ({merged} merged): "
          f"latency p50 {row['latency_p50_s']:.3f} s, max "
          f"{row['latency_max_s']:.3f} s, {row['conformers_per_s']:.1f} "
          f"conformers/s; K1 {k1} launches = {forwards} forwards; "
          f"{row['ladders_captured_during_requests']} captures during "
          f"requests; merged replies are the packed runner's bit for "
          f"bit: {direct_same}; merged against alone at the same batch "
          f"size bit for bit {sum(s['bitwise'] for s in same)} of "
          f"{len(same)}, at other sizes max {max(other, default=0):.3e} "
          f"of the largest coordinate; after {GROWTH_STEPS} steps {growth}; "
          f"peak reserved "
          f"{row['peak_reserved_mib']:.0f} MiB; evaluate MAT-R "
          f"{scored.get('MAT-R_mean')}", flush=True)
    return failures


def serve_growth(qmodel, qcfg, qmols, sets, dev) -> dict:
    """Merged against alone across batch sizes, from a QM9 server's own
    replies on a GROWTH_STEPS-step ladder of the servers' kind: the
    burst's requests (merged chunks B=64 and 32) against each alone
    (B=16), max |diff| over the largest coordinate (`other_batch_size`);
    the planted fault, each alone run given another request's seed
    (`swapped_seeds`, the least over the requests); and the same burst
    with K1 at R=1 for every batch size (`r_pinned`): equal to
    `other_batch_size` when K1's R is not what makes a reply depend on
    its co-traffic."""
    import numpy as np

    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.kernels import stack_packed
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.serve.server import submit

    def rel(a, b):
        got = [np.asarray(p, np.float32) for p in a["pos"]]
        want = [np.asarray(p, np.float32) for p in b["pos"]]
        return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
            / max(max(float(np.abs(w).max()) for w in want), 1e-30)

    def request(i, seed=None, **kw):
        return {"cmd": "generate", "test_set": sets[i % 2],
                "num_confs": SERVE_CONFS, "seed": 100 + (i if seed is None else seed),
                "save": False, "return_pos": True, **kw}

    def run(swap):
        runner = PackedGenerationRunner(
            qmodel, qcfg, make_diffusion(qcfg), serve_ladder(GROWTH_STEPS),
            buckets=(32,), chunk_size=SERVE_CHUNK, device=dev)
        _, port, thread = start_service(runner, max_nodes=32)
        replies = [r for r, _ in burst(port, [
            request(i) for i in range(SERVE_REQUESTS)])[0]]
        sound, fault = 0.0, float("inf")
        for i, r in enumerate(replies):
            alone = submit(request(i, batch=False), port=port, timeout=600)
            sound = max(sound, rel(r, alone))
            if swap:  # the next request of the same set, its seed
                other = submit(request(i, seed=(i + 2) % SERVE_REQUESTS,
                                       batch=False), port=port, timeout=600)
                fault = min(fault, rel(r, other))
        merged = sum(r.get("batched_with", 0) >= 1 for r in replies)
        stop_service(runner, port, thread)
        return sound, fault, merged

    sound, fault, merged = run(True)
    ranks_for = stack_packed.ranks_for
    stack_packed.ranks_for = lambda b, sm_count: 1
    try:
        pinned = run(False)[0]
    finally:
        stack_packed.ranks_for = ranks_for
    return dict(other_batch_size=sound, swapped_seeds=fault,
                r_pinned=pinned, merged=merged)


def serve_drugs(dmodel, dconf, dmols, dev, report) -> list:
    """(b) A Drugs server: 'tight-pksf' at bucket 64, warmed for the 50-
    and 56-atom molecules (each a tight list of its own) at every batch
    size; requests alternate between the two sizes, alone and merged, and
    no ladder may be captured while they run."""
    import numpy as np
    import torch

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.serve.server import submit, warm_classes

    root = os.path.join(OUT_DIR, "serve")
    sets = []
    for m in dmols[:2]:
        path = os.path.join(root, f"drugs_{m.num_nodes}.npz")
        save_molecules(path, [m])
        sets.append(path)
    runner = PackedGenerationRunner(
        dmodel, dconf.model, make_diffusion(dconf.model), serve_ladder(),
        buckets=dconf.buckets, chunk_size=DRUGS_CHUNK, device=dev)
    classes = warm_classes(runner, dmols[:2])
    torch.cuda.reset_peak_memory_stats(dev)
    svc, port, thread = start_service(runner, max_nodes=64)
    t0 = time.time()
    warm = submit({"cmd": "warm", "retry": True,
                   "nodes": sorted(m.num_nodes for m in classes.values())},
                  port=port, timeout=600)
    warm_s = time.time() - t0
    pools = runner.warmed_pool_bytes()
    fwd = runner.forward("tight-pksf")

    def request(i, **kw):
        return {"cmd": "generate", "test_set": sets[i % 2],
                "num_confs": SERVE_CONFS, "seed": 200 + i, "save": False,
                "return_pos": True, **kw}

    torch.cuda.synchronize(dev)
    zero_counts()
    calls0, captures0 = fwd.calls, device_counts(fwd)[2]
    t0 = time.time()
    alone = [submit(request(i, batch=False), port=port, timeout=600)
             for i in range(4)]
    alone_s = time.time() - t0
    merged, wall = burst(port, [request(i) for i in range(4)])
    counts, calls, captures = device_counts(fwd)
    forwards = calls - calls0
    k1 = counts.pop("stack_packed/stack_full:tight", 0)
    replies = alone + [r for r, _ in merged]
    failures = []
    if not all(r.get("ok") and np.isfinite(np.asarray(r["pos"])).all()
               for r in replies):  # one molecule a request
        failures.append(f"serve Drugs: a request failed or is not finite")
    if k1 != forwards or not k1 or counts:
        failures.append(f"serve Drugs: K1 launches {k1}, forwards "
                        f"{forwards}, other kernels {counts}")
    if captures != captures0:
        failures.append(f"serve Drugs: {captures - captures0} ladders "
                        f"captured during requests")
    peak = torch.cuda.max_memory_reserved(dev)
    if not stop_service(runner, port, thread):
        failures.append("serve Drugs: shutdown")
    latencies = sorted(lat for _, lat in merged)
    row = dict(classes=[list(map(str, k)) for k in classes],
               warm_s=warm_s, warmed_ladders=len(warm.get("compiled", [])),
               pools_mib=pools / 2 ** 20, peak_reserved_mib=peak / 2 ** 20,
               alone_s=alone_s, burst_s=wall,
               latency_p50_s=statistics.median(latencies),
               latency_max_s=latencies[-1],
               merged=sum(1 for r, _ in merged
                          if r.get("batched_with", 0) >= 1),
               forwards=forwards, k1_launches=k1,
               ladders_captured_during_requests=captures - captures0)
    report["serve"]["drugs"] = row
    print(f"serve Drugs ('tight-pksf', atoms "
          f"{[m.num_nodes for m in dmols[:2]]}, classes {list(classes)}): "
          f"warm-up {warm_s:.2f} s, {row['warmed_ladders']} ladders, pools "
          f"{row['pools_mib']:.1f} MiB; 4 requests alone alternating sizes "
          f"{alone_s:.2f} s, 4 at once {wall:.2f} s (p50 "
          f"{row['latency_p50_s']:.3f} s, {row['merged']} merged); K1 {k1} "
          f"launches = {forwards} forwards; "
          f"{row['ladders_captured_during_requests']} captures during "
          f"requests; peak reserved {row['peak_reserved_mib']:.0f} MiB",
          flush=True)
    return failures


def serve_cli(report) -> list:
    """(c) `python -m agdiff_torch.cli.serve` in a subprocess on phase 5b's
    reference .pt: --fast --packed --batch_window 0.2 --warm_nodes 23
    --max_nodes 32; `--submit` ping, generate and shutdown, each a client
    process; the server exits 0."""
    import socket

    from agdiff_torch.serve.server import submit

    ckpt = os.path.join(OUT_DIR, "cli", "ckpt", "model.pt")
    test_set = os.path.join(OUT_DIR, "serve", "qm9_0.npz")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "agdiff_torch.cli.serve", ckpt, "--fast",
           "--packed", "--batch_window", "0.2", "--warm_nodes", "23",
           "--max_nodes", "32", "--port", str(port), "--n_steps",
           str(CLI_STEPS), "--chunk_size", "16", "--ladder", "strided",
           "--sampling_type", "generalized", "--eta", "0", "--w_global",
           "0.3", "--clip_local", "20"]
    log = open(os.path.join(OUT_DIR, "serve", "cli_server.log"), "w")
    t0 = time.time()
    server = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
    failures, replies = [], {}
    try:
        deadline = time.time() + 300
        while True:
            try:
                submit({"cmd": "ping"}, port=port, timeout=10)
                break
            except OSError:
                if server.poll() is not None or time.time() > deadline:
                    raise SystemExit(f"serve CLI: the server did not start "
                                     f"(exit {server.poll()})")
                time.sleep(0.5)
        ready_s = time.time() - t0
        for name, req in (
                ("ping", {"cmd": "ping"}),
                ("generate", {"cmd": "generate", "test_set": test_set,
                              "num_confs": 4, "save": False,
                              "return_pos": True}),
                ("shutdown", {"cmd": "shutdown"})):
            proc = subprocess.run(
                [sys.executable, "-m", "agdiff_torch.cli.serve", "--submit",
                 json.dumps(req), "--port", str(port)], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            replies[name] = (proc.returncode,
                             json.loads(proc.stdout.strip().splitlines()[-1]))
        rc = server.wait(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        log.close()
    ok = {k: (rc_k == 0 and r.get("ok")) for k, (rc_k, r) in replies.items()}
    if not all(ok.values()) or rc != 0 or len(ok) != 3:
        failures.append(f"serve CLI: exit {rc}, replies "
                        f"{ {k: r for k, (_, r) in replies.items()} }")
    gen = replies.get("generate", (1, {}))[1]
    row = dict(command=" ".join(cmd[1:]), ready_s=ready_s, exit=rc,
               replies_ok=ok, samples=gen.get("samples"),
               seconds=gen.get("seconds"))
    report["serve"]["cli"] = row
    print(f"serve CLI: ready in {ready_s:.1f} s (load, build, warm 23 "
          f"atoms), --submit ping / generate ({row['samples']} conformers "
          f"in {row['seconds']} s) / shutdown ok {ok}, exit {rc}",
          flush=True)
    return failures


def run_engines(models, mols, dev, report) -> list:
    """(d) Each engine of PHASE10_ENGINES against the f32 engine on one
    forward (QM9: the fixtures in bucket 32 against engine None; Drugs:
    the 50-atom molecule x 4 in bucket 64 against 'tight'), slim8's
    reading beside its plain CPU run's, then GenerationRunner for
    ENGINE_STEPS steps, the counts set to 0 just before and read just
    after: K1's launches equal the forwards on the '-e16' K1 engines, no
    hand kernel on the others, every position finite."""
    import numpy as np
    import torch

    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.kernels import stack_packed as k1
    from agdiff_torch.models.fast_forward import engine_options
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    failures = []
    for label, engine, key, tol in PHASE10_ENGINES:
        cfg, model, cpu_model, buckets, chunk = models[key]
        opts = engine_options(engine)
        drugs = key == "drugs"
        batch_mols = [mols["drugs"][0]] * 4 if drugs else mols["qm9"]
        n = 64 if drugs else 32
        runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                                  SamplerConfig(n_steps=ENGINE_STEPS,
                                                w_global=0.3),
                                  buckets=buckets, chunk_size=chunk,
                                  device=dev, engine=engine)
        ref = runner.forward("tight" if drugs else None)
        batch = pad_molecules(batch_mols, n, device=dev)
        check_engines(runner.forward(engine)(batch), ref(batch), label,
                      tol, report)
        if engine.endswith("slim8") and cpu_model is not None:
            cpu = GenerationRunner(cpu_model, cfg, make_diffusion(cfg),
                                   SamplerConfig(), buckets=buckets,
                                   device="cpu", engine=engine)
            cpu_batch = pad_molecules(batch_mols, n)
            check_engines(cpu.forward(engine)(cpu_batch),
                          cpu.forward("tight" if drugs else None)(cpu_batch),
                          f"{label}_plain_cpu", tol, report)
        run_mols = mols["drugs"][:1] if drugs else mols["qm9"]
        fwd = runner.forward(engine)
        torch.cuda.synchronize(dev)
        zero_counts()
        calls0 = fwd.calls
        t0 = time.time()
        out = runner.run(run_mols, seed=SEED, num_confs=chunk)
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        counts = launch_counts()
        forwards = fwd.calls - calls0
        k1_name = (None if opts.mode not in k1.MODES else "stack_packed/"
                   + k1.variant(opts.mode, opts.approx, opts.tight))
        launches = counts.pop(k1_name, 0) if k1_name else 0
        finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in out)
        if counts or (k1_name and launches != forwards) or not forwards \
                or not finite:
            failures.append(f"engine {label}: K1 {launches} launches, "
                            f"forwards {forwards}, other kernels {counts}, "
                            f"finite {finite}")
        n_conf = sum(m.meta["pos_gen"].shape[0] for m in out)
        report["engines"][label] = dict(
            engine=engine, forwards=forwards, k1_launches=launches,
            other_launches=counts, wall_s=wall,
            ms_per_step=wall * 1e3 / forwards, conformers=n_conf,
            finite=finite)
        print(f"engine {label} ({'Drugs' if drugs else 'QM9'}, "
              f"{ENGINE_STEPS} steps, chunk {chunk}): {forwards} forwards, "
              f"K1 launches {launches}, other kernels {counts or 0}, "
              f"{wall * 1e3 / forwards:.3f} ms/step with its captures, "
              f"finite {finite}", flush=True)
        for s in runner._samplers.values():
            s.release()
        del runner
        torch.cuda.empty_cache()
    return failures


# ---- phase 11: bf16 training, distillation and the student -------------------

FAST_CONFIG = "qm9_fast.yml"   # hidden 128, 6 + 4 convs, bf16, packed_pairs,
                               # B=64, EMA 0.999, step_chunk 16
FAST_ITERS = 128        # through cli/train.py, synthetic_dataset(512)
FAST_VAL_FREQ = 64      # validations and checkpoints at 64 and 128
FAST_RESUME_FROM = 64   # 64 resumed iterations against the same of the run
DISTILL_STAGES = "32,16"
DISTILL_ITERS = 32      # a stage, through cli/distill.py (2 chunks of 16)
DISTILL_VAL_FREQ = 16   # validations and checkpoints at 16 and 32
DISTILL_STEP_STUDENT = 16   # the steps' ladder (d): 16 student steps
STUDENT_STEPS = 16      # the stage-16 student's strided DDIM ladder
STUDENT_MOLS = 16       # synthetic QM9-size molecules it generates
STUDENT_CONFS = 4       # conformers a molecule a served request
STUDENT_REQUESTS = 8    # concurrent requests of two molecules each
STUDENT_STREAM = 4      # requests of the single stream, one at a time
# The bf16 module on the card against the bf16 module on the CPU, each
# score plane on its mask as shares of its max |CPU value| (max, median,
# p99, share beyond 1%): every operation rounds to bf16, so a sum taken
# in another order flips a rounding that later layers carry on, more than
# in K1, whose sums stay f32. Read on an H100 (80GB HBM3, 700 W): global
# 6.5e-3, 0, 4.3e-3, 0; local 2.25e-2, 1.25e-3, 1.25e-2, 1.7e-2 (|local|
# to 50, where a bf16 unit is 0.25).
MODULE_BF16_LIMITS = dict(max_rel=5e-2, median_rel=5e-3, p99_rel=3e-2,
                          beyond_1pct=5e-2)
# The bf16 train step (and the bf16 distill step) on the card against the
# same step on the CPU (TF32 off): the losses relative to themselves; the
# worst gradient leaf's max |diff| as a share of the model's largest |g|;
# the median over leaves of |diff| / |g| (L2 norms); each running
# statistic as a share of max(its max, 1). bf16 sums of many terms leave
# single elements of some leaves (biases ahead of a BatchNorm, whose true
# gradient is 0) far off in relative terms, so no element-wise limit on
# the leaf's own scale (STEP_LIMITS) holds at bf16. Read on an H100
# (80GB HBM3, 700 W), train step / distill step: loss 3.3e-4 / 9.3e-5,
# worst leaf 6.5e-3 / 4.4e-2 (six bf16 units of the largest |g|), median
# 2.4e-2 / 7.0e-3, statistics 1.73e-3 / 0; the train step's faults:
# statistics 5.7e-3 (BatchNorm at bf16), loss 5.9e-3 and statistics
# 3.2e-3 (the position cast left out), loss 4.6e-2 (biases dropped),
# statistics 0.82 (stale running update).
BF16_STEP_LIMITS = dict(loss_rel=1.5e-3, grad_top_rel=0.1,
                        grad_norm_median=7e-2, stats_max_rel=2.5e-3)
BF16_TRAIN_FAULTS = ("bn_stats_bf16", "position_cast_left_out",
                     "bias_dropped", "stale_running_update")
DISTILL_FAULTS = ("teacher_second_step_dropped", "first_graph_sigma",
                  "eps_weighting", "clip_local_left_out")


@contextlib.contextmanager
def bf16_fault(name):
    """A planted fault in the bf16 train step: BatchNorm's batch
    statistics taken at bf16; the distances taken on f32 positions and
    rounded to bf16 once (the position cast left out); the bias of every
    one-output bf16 layer dropped; the running statistics left unmoved."""
    import torch

    from agdiff_torch.nn import common
    from agdiff_torch.ops import graph, masked

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "bn_stats_bf16":
        real = masked.masked_batch_norm_stats

        def bf16_stats(x, mask, group=None):
            mean, var, count = real(x.bfloat16(), mask, group=group)
            return mean.float(), var.float(), count
        patch(masked, "masked_batch_norm_stats", bf16_stats)
    elif name == "position_cast_left_out":
        real = graph.pairwise_distance
        patch(graph, "pairwise_distance", lambda pos, other=None: real(
            pos.float(), None if other is None else other.float()).to(
                pos.dtype))
    elif name == "bias_dropped":
        real = common.Linear.forward

        def no_bias(self, x):
            if self.compute_dtype == torch.float32 or self.out_features != 1:
                return real(self, x)
            cd = self.compute_dtype
            return torch.matmul(x.to(cd), self.weight.to(cd).t())
        patch(common.Linear, "forward", no_bias)
    elif name == "stale_running_update":
        ctx = common.frozen_running_stats()
        ctx.__enter__()
        saved.append((None, ctx, None))
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            if obj is None:
                attr.__exit__(None, None, None)
            else:
                setattr(obj, attr, value)


@contextlib.contextmanager
def distill_fault(name):
    """A planted fault in the distillation loss: the teacher's second DDIM
    sub-step dropped (its drift taken as 0, so the target lands at the
    mid point); the first graph's sigmas used for every graph; the 'eps'
    weighting in place of 'trunc-snr'; clip_local left out of the
    drift."""
    from agdiff_torch.train import distill

    cls = distill.DistillLoss
    saved = []

    def patch(attr, value):
        saved.append((attr, getattr(cls, attr)))
        setattr(cls, attr, value)

    if name == "teacher_second_step_dropped":
        real, teacher_calls = cls.drift, [0]

        def drift(self, module, batch, pos, sigma):
            import torch

            out = real(self, module, batch, pos, sigma)
            if torch.is_grad_enabled():       # the student's: a new loss
                teacher_calls[0] = 0
                return out
            teacher_calls[0] += 1
            return torch.zeros_like(out) if teacher_calls[0] == 2 else out
        patch("drift", drift)
    elif name == "first_graph_sigma":
        real = cls.sigma_of
        patch("sigma_of", lambda self, idx: real(self, idx)[:1].expand(
            idx.shape))
    elif name in ("eps_weighting", "clip_local_left_out"):
        real = cls.__init__

        def init(self, *args, **kw):
            real(self, *args, **kw)
            if name == "eps_weighting":
                self.weighting = "eps"
            else:
                self.sampler_config = dataclasses.replace(
                    self.sampler_config, clip_local=None)
        patch("__init__", init)
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for attr, value in reversed(saved):
            setattr(cls, attr, value)


def bf16_step_errors(got, ref) -> dict:
    """A bf16 step on the card (`got`) against the CPU's (`ref`), both
    step_result tuples, on BF16_STEP_LIMITS's scales."""
    import numpy as np
    import torch

    mg, gg, bg, _, _ = got
    mr, gr, br, _, _ = ref
    loss_rel = max(abs(mg[k] - mr[k]) / abs(mr[k])
                   for k in ("loss", "loss_global", "loss_local") if k in mr)
    top = max(float(g.abs().max()) for g in gr.values())
    worst, norms = (0.0, ""), []
    for name, g in gr.items():
        d = gg[name] - g
        e = float(d.abs().max()) / top if bool(torch.isfinite(d).all()) \
            else float("inf")
        if e >= worst[0]:
            worst = (e, name)
        norms.append(float(d.norm()) / max(float(g.norm()), 1e-30))
    stats = max((float((bg[n] - b).abs().max()) / max(float(b.abs().max()),
                                                      1.0)
                 for n, b in br.items()), default=0.0)
    row = dict(loss_rel=loss_rel, grad_top_rel=worst[0],
               grad_top_rel_leaf=worst[1],
               grad_norm_median=float(np.median(norms)),
               stats_max_rel=stats, grad_top=top, loss=mg["loss"],
               loss_ref=mr["loss"])
    row["broken"] = [k for k, lim in BF16_STEP_LIMITS.items()
                     if not row[k] <= lim]
    return row


def print_step_rows(title, rows, limits, failures):
    """Print each row; a sound row must break no limit, a planted fault's
    at least one."""
    print(f"{title}: limits {limits}", flush=True)
    for label, row in rows.items():
        shown = ", ".join(f"{k} {row[k]:.2e}" for k in limits)
        print(f"  {label}: {shown}; broken {row['broken']}", flush=True)
        fault = label.startswith("fault")
        if fault and not row["broken"]:
            failures.append(f"{title}: {label} breaks no limit")
        if not fault and row["broken"]:
            failures.append(f"{title}: {label} breaks {row['broken']}")


def fast_config():
    from agdiff_torch.config import load_config

    return load_config(os.path.join(ROOT, "configs", FAST_CONFIG))


def check_bf16_module(dev, report) -> list:
    """(a) The bf16 module (configs/qm9_fast.yml widths, seeded random
    weights, the QM9 fixtures) on the card against the same module on
    the CPU, and against the f32 module of the same weights on the card
    within the engine gate."""
    import torch

    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.data.fixture import load_fixture
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_random

    cfg = fast_config().model
    f32 = dataclasses.replace(cfg, dtype="float32")
    cpu = init_random(DualEncoderEpsNetwork(cfg), SEED).eval()
    card = DualEncoderEpsNetwork(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev).eval()
    full = DualEncoderEpsNetwork(f32)
    full.load_state_dict(cpu.state_dict())
    full = full.to(dev).eval()
    mols = load_fixture()
    batch = pad_molecules(mols, 32)
    with torch.no_grad():
        ref = cpu(batch)
        got = card(batch.to(dev))
        wide = full(batch.to(dev))
    rows, failures = {}, []
    for key, mask in (("global", "edge_mask"), ("local", "local_mask")):
        m = getattr(ref, mask)
        if not torch.equal(getattr(got, mask).cpu(), m):
            failures.append(f"bf16 module: the card's {mask} differs")
        rows[key] = errors(getattr(got, f"edge_inv_{key}").cpu(),
                           getattr(ref, f"edge_inv_{key}"), m)
    broken = broken_limits(rows, {"global": MODULE_BF16_LIMITS,
                                  "local": MODULE_BF16_LIMITS})
    if broken:
        failures.append(f"bf16 module, card against CPU: {broken}")
    report["distill"]["module"] = rows
    print(f"bf16 module (qm9_fast.yml, {len(mols)} QM9 fixtures, B="
          f"{batch.num_graphs}) on the card against the CPU: " + "; ".join(
              f"{k} max {r['max_rel']:.2e} median {r['median_rel']:.2e} "
              f"p99 {r['p99_rel']:.2e}" for k, r in rows.items())
          + f" (limits {MODULE_BF16_LIMITS}); broken {broken}", flush=True)
    check_engines(got, wide, "bf16_module", ENGINE_TOL, report)
    return failures


def check_bf16_train_step(dev, train_mols, report) -> list:
    """(b) One bf16 train step (qm9_fast.yml: packed_pairs) on the card
    against the CPU's, and its planted faults on the card."""
    import copy

    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_like_jax

    config = fast_config()
    batch, t, noise = train_batch(config, train_mols)
    init = init_like_jax(DualEncoderEpsNetwork(config.model),
                         torch.Generator().manual_seed(config.train.seed))
    t0 = time.time()
    ref = train_step_on(config, copy.deepcopy(init), torch.device("cpu"),
                        batch, t, noise)
    cpu_s = time.time() - t0
    rows = {"card_vs_cpu": bf16_step_errors(train_step_on(
        config, copy.deepcopy(init), dev, batch, t, noise), ref)}
    for name in BF16_TRAIN_FAULTS:
        with bf16_fault(name):
            rows[f"fault {name}"] = bf16_step_errors(train_step_on(
                config, copy.deepcopy(init), dev, batch, t, noise), ref)
    report["distill"]["bf16_step"] = rows
    failures = []
    print_step_rows(f"bf16 train step (qm9_fast.yml, B={batch.num_graphs}, "
                    f"loss {ref[0]['loss']:.4f} on the CPU in {cpu_s:.1f} "
                    f"s)", rows, BF16_STEP_LIMITS, failures)
    return failures


def run_fast_training(dev, report):
    """(c) cli/train.py on configs/qm9_fast.yml as it stands (bf16,
    packed_pairs, EMA 0.999, step_chunk 16) with --synthetic 512: the
    losses finite and falling, a resume from FAST_RESUME_FROM equal to
    the run bit for bit, it/s. Returns (failures, the run's log dir)."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from agdiff_torch.cli import train as train_cli
    from agdiff_torch.train.checkpoint import load_checkpoint

    root = os.path.join(OUT_DIR, "distill")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(ROOT, "configs", FAST_CONFIG)) as f:
        raw = yaml.safe_load(f)
    raw["train"].update(max_iters=FAST_ITERS, val_freq=FAST_VAL_FREQ)
    cfg_path = os.path.join(root, "qm9_fast.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    synth = ["--synthetic", str(TRAIN_MOLECULES), "--deterministic",
             "--device", str(dev)]
    try:
        t0 = time.time()
        full = train_cli.main([cfg_path, "--logdir",
                               os.path.join(root, "train"), *synth])
        wall = time.time() - t0
        resumed_dir = os.path.join(root, "resumed")
        shutil.copytree(full.log_dir, resumed_dir)
        shutil.rmtree(os.path.join(resumed_dir, "checkpoints",
                                   str(FAST_ITERS)))
        t0 = time.time()
        resumed = train_cli.main([resumed_dir, "--resume_iter",
                                  str(FAST_RESUME_FROM), *synth])
        resume_s = time.time() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    failures = []
    losses = np.asarray(full.losses)
    first, last = (float(losses[:LOSS_WINDOW].mean()),
                   float(losses[-LOSS_WINDOW:].mean()))
    if len(losses) != FAST_ITERS or not np.isfinite(losses).all():
        failures.append(f"bf16 train: {len(losses)} losses, finite "
                        f"{bool(np.isfinite(losses).all())}")
    if not last < first:
        failures.append(f"bf16 train: the last {LOSS_WINDOW} losses' mean "
                        f"{last:.4f} is not below the first's {first:.4f}")
    ckpt = lambda d: load_checkpoint(os.path.join(
        d, "checkpoints", str(FAST_ITERS)))
    bad = same_checkpoint(ckpt(full.log_dir), ckpt(resumed_dir))
    same_losses = resumed.losses == full.losses[FAST_RESUME_FROM:]
    if bad or not same_losses:
        failures.append(f"bf16 train resume: iterations "
                        f"{FAST_RESUME_FROM + 1}-{FAST_ITERS} differ from "
                        f"the uninterrupted run (losses equal "
                        f"{same_losses}; {bad[:5]})")
    shutil.rmtree(resumed_dir)
    row = dict(iterations=FAST_ITERS, wall_s=wall,
               it_per_s=FAST_ITERS / wall, loss_first=first, loss_last=last,
               resume_wall_s=resume_s, resumed_equal=not bad and same_losses,
               dtype=full.config.model.dtype,
               packed_pairs=full.config.model.packed_pairs,
               step_chunk=full.config.train.step_chunk,
               ema_decay=full.config.train.ema_decay)
    report["distill"]["train_run"] = row
    print(f"bf16 train (cli/train.py {FAST_CONFIG}: {row['dtype']}, "
          f"packed_pairs {row['packed_pairs']}, step_chunk "
          f"{row['step_chunk']}, EMA {row['ema_decay']}): {FAST_ITERS} "
          f"iterations in {wall:.1f} s ({row['it_per_s']:.2f} it/s with "
          f"loader, validations and checkpoints, deterministic "
          f"algorithms); loss mean of the first {LOSS_WINDOW} {first:.4f}, "
          f"of the last {last:.4f}; resumed from {FAST_RESUME_FROM}: "
          f"torch.equal to the run {not bad} (losses {same_losses})",
          flush=True)
    return failures, full.log_dir


def distill_sampler():
    from agdiff_torch.sampling.langevin import SamplerConfig

    return SamplerConfig(sampling_type="generalized", eta=0.0,
                         ladder="strided", w_global=0.3,
                         global_start_sigma=0.5, clip=1000.0,
                         clip_local=20.0)


def distill_step_on(config, teacher, device, batch, k, noise):
    """One distill step (a student copied from `teacher`, both on
    `device`) on the injected k and noise: step_result's tuple."""
    from agdiff_torch.train import distill

    teacher = teacher.to(device).eval().requires_grad_(False)
    state = distill.create_distill_state(config, teacher, device, SEED)
    before = {n: p.detach().cpu().clone()
              for n, p in state.module.named_parameters()}
    m = distill.make_distill_step(config, distill_sampler(),
                                  DISTILL_STEP_STUDENT, device)(
        state, teacher, batch.to(device), k.to(device), noise.to(device))
    return step_result(m, state.module, before)


def check_distill_step(dev, train_mols, report) -> list:
    """(d) One distill step on the card against the CPU's, at f32 (phase
    9's STEP_LIMITS) and at bf16 (BF16_STEP_LIMITS), each with the
    planted faults on the card."""
    import copy

    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_like_jax

    base = fast_config()
    batch, _, noise = train_batch(base, train_mols)
    k = torch.randint(0, DISTILL_STEP_STUDENT, (batch.num_graphs,),
                      generator=torch.Generator().manual_seed(SEED))
    failures, rows_all = [], {}
    for dtype in ("float32", "bfloat16"):
        config = dataclasses.replace(base, model=dataclasses.replace(
            base.model, dtype=dtype), train=dataclasses.replace(
            base.train, ema_decay=0.0))
        init = init_like_jax(DualEncoderEpsNetwork(config.model),
                             torch.Generator().manual_seed(SEED)).eval()
        t0 = time.time()
        ref = distill_step_on(config, copy.deepcopy(init),
                              torch.device("cpu"), batch, k, noise)
        cpu_s = time.time() - t0
        errs = (functools.partial(step_errors, lr=config.train.optimizer.lr)
                if dtype == "float32" else bf16_step_errors)
        limits = STEP_LIMITS if dtype == "float32" else BF16_STEP_LIMITS
        rows = {"card_vs_cpu": errs(distill_step_on(
            config, copy.deepcopy(init), dev, batch, k, noise), ref)}
        for name in DISTILL_FAULTS:
            with distill_fault(name):
                rows[f"fault {name}"] = errs(distill_step_on(
                    config, copy.deepcopy(init), dev, batch, k, noise), ref)
        rows_all[dtype] = rows
        print_step_rows(f"distill step {dtype} (qm9_fast.yml widths, B="
                        f"{batch.num_graphs}, {DISTILL_STEP_STUDENT} student "
                        f"steps, loss {ref[0]['loss']:.4f} on the CPU in "
                        f"{cpu_s:.1f} s)", rows, limits, failures)
    report["distill"]["distill_step"] = rows_all
    return failures


def run_distill_cli(dev, teacher_dir, report):
    """(e) cli/distill.py from (c)'s log dir (--ema_teacher, stages 32 and
    16): both stages finish with finite validation losses; a second run
    skips them; stage 16 as a cut after its first checkpoint leaves it
    (DONE.json and the later checkpoint gone, the best pointer at the
    first) resumes from that checkpoint. Returns (failures, stage-16
    dir)."""
    import json
    import shutil

    import numpy as np

    from agdiff_torch.cli import distill as distill_cli

    logdir = os.path.join(OUT_DIR, "distill", "students")
    args = [teacher_dir, "--ema_teacher", "--stages", DISTILL_STAGES,
            "--iters", str(DISTILL_ITERS), "--val_freq",
            str(DISTILL_VAL_FREQ), "--synthetic", str(TRAIN_MOLECULES),
            "--logdir", logdir, "--device", str(dev)]
    failures = []
    t0 = time.time()
    summary = distill_cli.main(args)
    wall = time.time() - t0
    finite = all(np.isfinite(s["best_val"]) for s in summary)
    stages = [int(s) for s in DISTILL_STAGES.split(",")]
    if [s["stage"] for s in summary] != stages or not finite:
        failures.append(f"distill: stages {summary}")
    t0 = time.time()
    again = distill_cli.main(args)
    skip_s = time.time() - t0
    if not all(s.get("resumed") for s in again):
        failures.append(f"distill: the rerun did not skip {again}")
    last = os.path.join(logdir, f"stage{stages[-1]}")
    ckpts = os.path.join(os.path.abspath(last), "checkpoints")
    first, *later = sorted(int(n) for n in os.listdir(ckpts))
    os.remove(os.path.join(last, "DONE.json"))
    for it in later:
        shutil.rmtree(os.path.join(ckpts, str(it)))
    with open(os.path.join(last, "best_model", "POINTER"), "w") as f:
        f.write(os.path.join(ckpts, str(first)))
    t0 = time.time()
    distill_cli.main(args)
    resume_s = time.time() - t0
    with open(os.path.join(logdir, "log.txt")) as f:
        resumed = (f"[stage {stages[-1]}] resuming from iter "
                   f"{first}") in f.read()
    if not later:
        failures.append("distill: one checkpoint in the last stage")
    with open(os.path.join(logdir, "STAGES.json")) as f:
        keys = sorted(json.load(f))
    done = os.path.exists(os.path.join(last, "DONE.json"))
    if not (resumed and done) or keys != ["sampler", "stages",
                                          "weighting"]:
        failures.append(f"distill: resumed {resumed}, done {done}, "
                        f"STAGES.json keys {keys}")
    iters = DISTILL_ITERS * len(stages)
    row = dict(stages=summary, wall_s=wall, it_per_s=iters / wall,
               skip_s=skip_s, resume_s=resume_s, resumed=resumed,
               resumed_from=first)
    report["distill"]["cli"] = row
    print(f"distill (cli/distill.py --ema_teacher --stages {DISTILL_STAGES} "
          f"--iters {DISTILL_ITERS}): {iters} iterations in {wall:.1f} s "
          f"({row['it_per_s']:.2f} it/s with loader, validations and "
          f"checkpoints); best validation losses " + ", ".join(
              f"stage {s['stage']} {s['best_val']:.5f}" for s in summary)
          + f"; the rerun skipped both in {skip_s:.1f} s; stage "
          f"{stages[-1]} cut after its first checkpoint ({first}) resumed from "
          f"it: {resumed} ({resume_s:.1f} s)", flush=True)
    return failures, last


def student_generate(dev, stage_dir, report):
    """(f) The stage-16 student through cli/generate.py (--fast, strided
    DDIM at eta 0, 16 steps, w_global 0.3, clip_local 20) on
    STUDENT_MOLS synthetic QM9-size molecules: K1's launches equal the
    forwards and no other hand kernel runs, positions finite; the
    student's 'pksf' scores within the engine gate of the f32 engine on
    one batch; the samples scored by cli/eval_covmat.py (printed, not
    gated). Returns (failures, K1 launches)."""
    import numpy as np
    import torch

    from agdiff_torch.cli import generate as gen_cli
    from agdiff_torch.cli._common import load_inference_bundle
    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.eval import generate as gen_mod
    from agdiff_torch.models.fast_forward import build_fast_forward

    out = os.path.join(OUT_DIR, "distill", "samples")
    runners = []
    real_init = gen_mod.GenerationRunner.__init__

    def spy(self, *a, **kw):
        real_init(self, *a, **kw)
        runners.append(self)

    gen_mod.GenerationRunner.__init__ = spy
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    try:
        gen_cli.main([stage_dir, "--fast", "--sampling_type", "generalized",
                      "--eta", "0", "--ladder", "strided", "--n_steps",
                      str(STUDENT_STEPS), "--w_global", "0.3",
                      "--clip_local", "20", "--synthetic",
                      str(STUDENT_MOLS), "--out_dir", out, "--no_resume",
                      "--device", str(dev)])
    finally:
        gen_mod.GenerationRunner.__init__ = real_init
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    (runner,) = runners
    fwd = runner.forwards.get("pksf")
    forwards = 0 if fwd is None else fwd.calls
    k1 = counts.pop("stack_packed/stack_full:triu", 0)
    samples = os.path.join(out, "samples_all.npz")
    done = gen_mod.load_samples(samples)
    finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in done)
    conformers = sum(m.meta["pos_gen"].shape[0] for m in done)
    failures = []
    if k1 != forwards or not k1 or counts or not finite \
            or len(done) != STUDENT_MOLS:
        failures.append(f"student generate: K1 {k1}, forwards {forwards}, "
                        f"other kernels {counts}, finite {finite}, "
                        f"molecules {len(done)}")
    config, model, _, _ = load_inference_bundle(stage_dir)
    model = model.to(dev)
    mols = synthetic_dataset(STUDENT_MOLS, seed=7, num_conformers=3)
    batch = pad_molecules(mols, 32, device=dev)
    with torch.no_grad():
        f32 = dataclasses.replace(config.model, dtype="float32")
        check_engines(build_fast_forward(config.model, model, "pksf")(batch),
                      build_fast_forward(f32, model, None)(batch),
                      "student_pksf", ENGINE_TOL, report)
    proc = subprocess.run(
        [sys.executable, "-m", "agdiff_torch.cli.eval_covmat", samples,
         "--num_workers", "4"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"eval_covmat exit {proc.returncode}:\n"
                         f"{proc.stderr[-3000:]}")
    with np.load(os.path.splitext(samples)[0] + "_covmat.npz") as res:
        covr, matr, thr = res["CoverageR"], res["MatchingR"], \
            res["thresholds"]
    i = int(np.argmin(np.abs(thr - 0.5)))
    row = dict(molecules=len(done), conformers=conformers,
               steps=STUDENT_STEPS, wall_s=wall, forwards=forwards,
               k1_launches=k1, finite=finite, scored=int(covr.shape[0]),
               cov_r_at=float(thr[i]),
               cov_r_mean=float(covr[:, i].mean()) if len(covr) else None,
               mat_r_mean=float(matr.mean()) if len(matr) else None)
    report["distill"]["generate"] = row
    print(f"student generate (cli/generate.py {os.path.basename(stage_dir)}"
          f" --fast, strided DDIM eta 0, {STUDENT_STEPS} steps): "
          f"{len(done)} molecules, {conformers} conformers in {wall:.1f} s, "
          f"K1 {k1} launches = {forwards} forwards, other kernels "
          f"{counts}, finite {finite}; COV-R at {row['cov_r_at']:.2f} A "
          f"{row['cov_r_mean']}, MAT-R {row['mat_r_mean']} A "
          f"({row['scored']} scored; not gated: the teacher trained "
          f"{FAST_ITERS} iterations)", flush=True)
    return failures, k1


def student_serve(dev, stage_dir, report):
    """(g) The stage-16 student served (GenerationService,
    PackedGenerationRunner 'pksf', merging within SERVE_WINDOW), warmed at
    start-up for the requests' sizes at every batch size: a single stream
    of STUDENT_STREAM requests, then STUDENT_REQUESTS concurrent requests,
    each of two molecules x STUDENT_CONFS conformers. Every reply ok, no
    capture during requests, K1's launches equal the forwards. Returns
    (failures, K1 launches)."""
    import torch

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.cli._common import load_inference_bundle
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.serve.server import submit

    root = os.path.join(OUT_DIR, "distill", "serve")
    os.makedirs(root, exist_ok=True)
    mols = synthetic_dataset(2 * STUDENT_REQUESTS, seed=11,
                             num_conformers=3)
    sets = []
    for i in range(STUDENT_REQUESTS):
        path = os.path.join(root, f"request_{i}.npz")
        save_molecules(path, mols[2 * i:2 * i + 2])
        sets.append(path)
    config, model, _, _ = load_inference_bundle(stage_dir)
    ladder = SamplerConfig(n_steps=STUDENT_STEPS, ladder="strided",
                           sampling_type="generalized", eta=0.0,
                           w_global=0.3, clip_local=20.0)
    runner = PackedGenerationRunner(
        model, config.model, make_diffusion(config.model), ladder,
        buckets=(32,), chunk_size=SERVE_CHUNK, device=dev)
    svc, port, thread = start_service(runner, max_nodes=32)
    t0 = time.time()
    warm = submit({"cmd": "warm", "retry": True,
                   "nodes": sorted({m.num_nodes for m in mols})},
                  port=port, timeout=600)
    warm_s = time.time() - t0
    fwd = runner.forward("pksf")

    def request(i):
        return {"cmd": "generate", "test_set": sets[i],
                "num_confs": STUDENT_CONFS, "seed": 200 + i, "save": False}

    torch.cuda.synchronize(dev)
    zero_counts()
    calls0, captures0 = fwd.calls, device_counts(fwd)[2]
    stream = []
    t0 = time.time()
    for i in range(STUDENT_STREAM):
        t1 = time.time()
        stream.append((submit(request(i), port=port, timeout=600),
                       time.time() - t1))
    stream_s = time.time() - t0
    replies, wall = burst(port, [request(i)
                                 for i in range(STUDENT_REQUESTS)])
    counts, calls, captures = device_counts(fwd)
    forwards = calls - calls0
    k1 = counts.pop("stack_packed/stack_full:triu", 0)
    failures = []
    every = stream + replies
    if not all(r.get("ok") for r, _ in every):
        failures.append(f"student serve: a request failed: "
                        f"{[r for r, _ in every if not r.get('ok')]}")
    if k1 != forwards or not k1 or counts:
        failures.append(f"student serve: K1 launches {k1}, forwards "
                        f"{forwards}, other kernels {counts}")
    if captures != captures0:
        failures.append(f"student serve: {captures - captures0} ladders "
                        f"captured during requests")
    if not stop_service(runner, port, thread):
        failures.append("student serve: shutdown")
    lat = sorted(t for _, t in replies)
    slat = sorted(t for _, t in stream)
    confs = sum(r.get("samples", 0) for r, _ in replies)
    sconfs = sum(r.get("samples", 0) for r, _ in stream)
    row = dict(warm_s=warm_s, warmed_ladders=len(warm.get("compiled", [])),
               requests=STUDENT_REQUESTS, conformers=confs, burst_s=wall,
               conformers_per_s=confs / wall,
               latency_p50_s=statistics.median(lat), latency_max_s=lat[-1],
               stream_requests=STUDENT_STREAM,
               stream_latency_p50_s=statistics.median(slat),
               stream_latency_max_s=slat[-1],
               stream_conformers_per_s=sconfs / stream_s,
               merged=sum(1 for r, _ in replies
                          if r.get("batched_with", 0) >= 1),
               forwards=forwards, k1_launches=k1,
               ladders_captured_during_requests=captures - captures0)
    report["distill"]["serve"] = row
    print(f"student serve ('pksf', {STUDENT_STEPS} strided DDIM steps at "
          f"eta 0, chunk {SERVE_CHUNK}): warm-up {warm_s:.2f} s, "
          f"{row['warmed_ladders']} ladders; a stream of {STUDENT_STREAM} "
          f"requests of 2 molecules x {STUDENT_CONFS} conformers: latency "
          f"p50 {row['stream_latency_p50_s']:.3f} s, max "
          f"{row['stream_latency_max_s']:.3f} s, "
          f"{row['stream_conformers_per_s']:.1f} conformers/s; "
          f"{STUDENT_REQUESTS} concurrent ({row['merged']} merged): latency "
          f"p50 {row['latency_p50_s']:.3f} s, max {row['latency_max_s']:.3f}"
          f" s, {row['conformers_per_s']:.1f} conformers/s; K1 {k1} "
          f"launches = {forwards} forwards; "
          f"{row['ladders_captured_during_requests']} captures during "
          f"requests ({report['card']})", flush=True)
    return failures, k1


def profile_distill(dev, train_mols, report):
    """(h) TRAIN_PROFILE_STEPS eager steps each of the bf16 train step
    and of the distill step at f32 and at bf16, B=64 (qm9_fast.yml)."""
    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_like_jax
    from agdiff_torch.train import distill
    from agdiff_torch.train.train_step import (
        create_train_state,
        make_train_step,
    )

    base = fast_config()
    batch = train_batch(base, train_mols)[0].to(dev)
    section = report["distill"]["profiles"] = {}
    state = create_train_state(base, dev)
    step = make_train_step(base, dev)
    profile_steps("profile bf16 train step", section, "train_bf16",
                  lambda: step(state, batch), batch)
    del state
    for dtype in ("float32", "bfloat16"):
        config = dataclasses.replace(base, model=dataclasses.replace(
            base.model, dtype=dtype), train=dataclasses.replace(
            base.train, ema_decay=0.0))
        teacher = init_like_jax(DualEncoderEpsNetwork(config.model),
                                torch.Generator().manual_seed(SEED)).to(dev)
        teacher.eval().requires_grad_(False)
        dstate = distill.create_distill_state(config, teacher, dev, SEED)
        dstep = distill.make_distill_step(config, distill_sampler(),
                                          DISTILL_STEP_STUDENT, dev)
        profile_steps(f"profile distill step {dtype}", section,
                      f"distill_{dtype}",
                      lambda: dstep(dstate, teacher, batch), batch)
        del dstate, teacher
        torch.cuda.empty_cache()


def run_distillation(dev, report):
    """Phase 11: (a)-(h) of the module docstring. Returns (failures, K1
    launches of the student's generate and serve runs)."""
    import shutil

    import torch

    from agdiff_torch.data.synthetic import synthetic_dataset

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("phase 11: TF32 must be off before the gates")
    report["distill"] = {"part_s": {}}
    mark = [time.time()]

    def part(name):
        now = time.time()
        report["distill"]["part_s"][name] = now - mark[0]
        mark[0] = now

    # the training split of the CLIs' --synthetic 512 (the steps' batches)
    mols = synthetic_dataset(TRAIN_MOLECULES,
                             seed=fast_config().train.seed)
    train_mols = mols[:int(len(mols) * 0.9)]
    failures = check_bf16_module(dev, report)
    part("a module")
    failures += check_bf16_train_step(dev, train_mols, report)
    part("b train step")
    failed, train_dir = run_fast_training(dev, report)
    failures += failed
    part("c cli/train.py")
    failures += check_distill_step(dev, train_mols, report)
    part("d distill step")
    failed, stage_dir = run_distill_cli(dev, train_dir, report)
    failures += failed
    part("e cli/distill.py")
    failed, k1_gen = student_generate(dev, stage_dir, report)
    failures += failed
    part("f student generate")
    failed, k1_serve = student_serve(dev, stage_dir, report)
    failures += failed
    part("g student serve")
    profile_distill(dev, train_mols, report)
    part("h profiles")
    print("phase 11 parts (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["distill"]["part_s"].items()),
        flush=True)
    # the checkpoints (tens of MB each) are not kept; the logs are
    for d, subdirs, _ in os.walk(os.path.join(OUT_DIR, "distill")):
        if "checkpoints" in subdirs:
            shutil.rmtree(os.path.join(d, "checkpoints"))
    report["distill"]["k1_launches"] = k1_gen + k1_serve
    return failures, k1_gen + k1_serve


# ---- phase 12: data parallelism --------------------------------------------

# (a) the CLIs' own path at world size 1 (one spawned rank, NCCL) against
# the same run without --num_devices, torch.equal
DP_MOLECULES = 128      # synthetic_dataset(128, seed=2021): 115 to train
DP_ITERS = 6            # cli/train.py iterations; a checkpoint at the last
DP_GEN_MOLS = 2         # cli/generate.py --engine pksf, held-out molecules
DP_GEN_STEPS = 20
# (b) two gloo ranks on card 0 (NCCL refuses two ranks on one device)
DP_LADDER_STEPS = 8     # the runner's ladders at B=128 (QM9) and B=48 (Drugs)
DP_SERVE_STEPS = 20     # the two-rank service's ladder
DP_TIMED_STEPS = 3      # data-parallel train steps timed on each rank
# the faults a data-parallel step must not have (tests/torch_port_dp_
# ranks.py plants the same on the CPU): per-rank BatchNorm statistics;
# statistics summed by an all-reduce without gradient (the cross-rank
# terms of their gradient lost); DDP's mean of per-rank mean losses; each
# rank drawing only its own share of the noise
DP_FAULTS = ("local_stats", "stats_without_grad", "ddp_mean", "own_noise")
DP_ENGINE_LIMITS = {"pksf": ENGINE_TOL, "tight-pksf": DRUGS_ENGINE_TOL}


@contextlib.contextmanager
def dp_fault(name):
    import torch

    from agdiff_torch.ops import masked
    from agdiff_torch.parallel.mesh import Mesh
    from agdiff_torch.train import train_step as ts

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "local_stats":
        real = masked.masked_batch_norm_stats
        patch(masked, "masked_batch_norm_stats",
              lambda x, mask, group=None: real(x, mask))
    elif name == "stats_without_grad":
        patch(Mesh, "sum_with_grad", lambda self, x: x + (
            self.all_reduce(x.detach().clone()) - x.detach()))
    elif name == "ddp_mean":
        real_loss, real_sum = ts.diffusion_loss, Mesh.sum_gradients

        def mean(self, params):
            real_sum(self, params)
            for p in params:
                p.grad /= self.world_size
        patch(ts, "diffusion_loss", lambda *a: real_loss(*a[:5]))
        patch(Mesh, "sum_gradients", mean)
    elif name == "own_noise":
        patch(ts, "global_draw_rows", lambda batch, group: (
            batch.num_graphs, slice(0, batch.num_graphs)))
    elif name == "cross_slice_skipped":
        # phase 14 (b): the ('dcn', 'dp') sum within each slice only
        def within(self, params):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            flat = self.axis(self.axis_names[-1]).all_reduce(
                torch.cat([g.reshape(-1) for g in grads]))
            for p, g in zip(params, flat.split([g.numel() for g in grads])):
                p.grad = g.view_as(p)
        patch(Mesh, "sum_gradients", within)
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def dp_every_rank(group, obj):
    """[each rank's obj], on every rank (broadcasts only)."""
    return [group.broadcast_object(obj if group.rank == r else None, src=r)
            for r in range(group.world_size)]


def dp_train_rank(group, case) -> dict:
    """One data-parallel train step of the case's initial weights on this
    rank's shard, with the global t and noise, a planted fault when the
    case names one: step_result's tuple; a sound step also checks every
    rank's parameters and statistics equal and times DP_TIMED_STEPS
    steps and the gradient all-reduce alone."""
    import copy

    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.parallel.data_parallel import check_replicas
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState, TrainStep

    config, dev = case["config"], group.device
    module = DualEncoderEpsNetwork(config.model)
    module.load_state_dict(case["init"])
    module = module.to(dev)
    state = TrainState(step=0, module=module,
                       optimizer=make_optimizer(module, config.train),
                       generator=torch.Generator(device=dev).manual_seed(0))
    before = {n: p.detach().cpu().clone()
              for n, p in module.named_parameters()}
    step = TrainStep(config, dev, group)
    shard = group.shard(case["batch"])
    with dp_fault(case.get("fault")):
        metrics = step(state, shard, case["t"].to(dev),
                       case["noise"].to(dev))
    # copies: on the CPU (a rehearsal) .cpu() would alias the parameters
    # the timed steps below move
    out = {"step": copy.deepcopy(step_result(metrics, module, before))}
    if case.get("fault") is None:
        check_replicas(module, group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            step(state, shard)
        torch.cuda.synchronize(dev)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
            / DP_TIMED_STEPS
        params = state.optimizer.params
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            group.sum_gradients(params)
        torch.cuda.synchronize(dev)
        out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3 \
            / DP_TIMED_STEPS
        out["grad_bytes"] = 4 * sum(p.numel() for p in params)
        out["collectives"] = dp_collective_split(group, step, state, shard)
    return out


def dp_collective_split(group, step, state, shard) -> dict:
    """One more step with the card synchronised around each of its
    all-reduces: (the step's ms so run, the all-reduces' ms in all and
    their number, and the gradient all-reduce's share of both). The
    synchronisations keep the card's own work out of a collective's wall
    time and lengthen the step; the split, not the sum, is the reading."""
    import torch

    from agdiff_torch.parallel.mesh import Mesh

    dev = group.device
    spans = []
    real = Mesh.all_reduce

    def timed(self, x):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        real(self, x)
        torch.cuda.synchronize(dev)
        spans.append(((time.perf_counter() - t0) * 1e3, x.numel()))
        return x

    Mesh.all_reduce = timed
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(state, shard)
        torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        Mesh.all_reduce = real
    grad = max(spans, key=lambda sp: sp[1])
    return dict(step_ms=step_ms, all_reduce_ms=sum(ms for ms, _ in spans),
                all_reduces=len(spans), grad_all_reduce_ms=grad[0],
                other_all_reduce_ms=sum(ms for ms, _ in spans) - grad[0])


def dp_ladder():
    """The DP ladders: the slices' 'ld' ladder (w_global 0.3) with
    bench.py's clip_local 20, DP_LADDER_STEPS steps."""
    from agdiff_torch.sampling.langevin import SamplerConfig

    return SamplerConfig(n_steps=DP_LADDER_STEPS, w_global=0.3,
                         clip_local=20.0)


def dp_model(cfg):
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_random

    return init_random(DualEncoderEpsNetwork(cfg), SEED)


def dp_ladder_rank(group, case) -> dict:
    """The runner's sampler over the group (its first run captures the
    graphs, the second is read): the gathered positions, this rank's
    launches by kernel, its forwards and ms/step."""
    import torch

    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion

    cfg, engine, dev = case["model_config"], case["engine"], group.device
    runner = GenerationRunner(
        dp_model(cfg), cfg, make_diffusion(cfg), dp_ladder(),
        buckets=case["buckets"], chunk_size=case["batch"].num_graphs,
        engine=engine, group=group)
    sampler = runner._sampler(engine, False,
                              runner._capacity_for(case["mol"], engine))
    fwd = runner.forward(engine)
    args = (case["batch"].to(dev), case["pos_init"].to(dev))
    noise = case["noise"].to(dev)
    sampler(*args, noise=noise)
    torch.cuda.synchronize(dev)
    zero_counts()
    calls0 = fwd.calls
    t0 = time.perf_counter()
    out = sampler(*args, noise=noise)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / DP_LADDER_STEPS
    return dict(pos=out.pos.cpu(), flags=out.nan_flags.cpu(),
                launches=launch_counts(), forwards=fwd.calls - calls0,
                ms_per_step=ms, graphs=sampler.graphed(args[0]))


def dp_serve_rank(group, case) -> dict:
    """Phase 10's QM9 burst through a service over the group: rank 0
    serves (warm-up by a request, then SERVE_REQUESTS concurrent requests,
    its counts read around the burst), rank 1 follows; each rank's
    captures against the ladders its warm-up pinned."""
    import torch

    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.graphed import LadderGraphs
    from agdiff_torch.serve.server import follow, submit

    cfg = case["model_config"]
    runner = PackedGenerationRunner(
        dp_model(cfg), cfg, make_diffusion(cfg), serve_ladder(DP_SERVE_STEPS),
        buckets=(32,), chunk_size=SERVE_CHUNK, group=group)
    fwd = runner.forward("pksf")
    zero_counts()
    start = LadderGraphs.captures   # the ladder cases' captures before
    out = {}
    if group.rank == 0:
        svc, port, thread = start_service(runner, max_nodes=32)
        warm = submit({"cmd": "warm", "retry": True, "nodes": case["nodes"]},
                      port=port, timeout=600)
        torch.cuda.synchronize(group.device)
        pinned = sum(len(s.pinned) for s in runner._samplers.values())
        before, calls0 = launch_counts(), fwd.calls
        zero_counts()
        captures0 = LadderGraphs.captures
        replies, wall = burst(port, [
            {"cmd": "generate", "test_set": case["sets"][i % 2],
             "num_confs": SERVE_CONFS, "seed": 100 + i, "save": False}
            for i in range(SERVE_REQUESTS)])
        out = dict(warm_ok=bool(warm.get("ok")), wall_s=wall,
                   ok=[bool(r.get("ok")) for r, _ in replies],
                   merged=sum(1 for r, _ in replies
                              if r.get("batched_with", 0) >= 1),
                   latencies=[lat for _, lat in replies],
                   burst_launches=launch_counts(),
                   burst_forwards=fwd.calls - calls0,
                   burst_captures=LadderGraphs.captures - captures0)
        launches = dict(collections.Counter(before)
                        + collections.Counter(launch_counts()))
        out["stopped"] = stop_service(runner, port, thread)
    else:
        follow(runner)
        pinned = sum(len(s.pinned) for s in runner._samplers.values())
        launches = launch_counts()
    out.update(captures=LadderGraphs.captures - start, pinned=pinned,
               launches=launches, forwards=fwd.calls)
    return out


def dp_card_world(group, cases) -> list:
    """Phase 12 (b) in each of two gloo ranks on card 0."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_counts()
    out = {"train": {k: dp_train_rank(group, c)
                     for k, c in cases["train"].items()},
           "ladders": {k: dp_ladder_rank(group, c)
                       for k, c in cases["ladders"].items()},
           "serve": dp_serve_rank(group, cases["serve"])}
    return dp_every_rank(group, out)


def dp_cli_world_one(dev, report) -> list:
    """(a) cli/train.py and cli/generate.py with --num_devices 1 (one
    spawned rank on the card, NCCL) against the same runs in this
    process."""
    import shutil

    import numpy as np
    import torch

    from agdiff_torch.cli import generate as gen_cli
    from agdiff_torch.cli import train as train_cli
    from agdiff_torch.eval.generate import load_samples
    from agdiff_torch.train.checkpoint import load_checkpoint

    root = os.path.join(OUT_DIR, "dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = write_train_config(os.path.join(root, "dp.yml"), max_iters=DP_ITERS,
                             val_freq=DP_ITERS, ema_decay=TRAIN_EMA)
    synth = ["--synthetic", str(DP_MOLECULES), "--deterministic"]
    runs, wall = {}, {}
    try:
        for label, extra in (("one", ["--device", str(dev)]),
                             ("world1", ["--num_devices", "1"])):
            t0 = time.time()
            runs[label] = train_cli.main([cfg, "--logdir", os.path.join(
                root, label), *synth, *extra])
            wall[label] = time.time() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    ckpt = lambda r: load_checkpoint(os.path.join(  # noqa: E731
        r.log_dir, "checkpoints", str(DP_ITERS)))
    bad = same_checkpoint(ckpt(runs["one"]), ckpt(runs["world1"]))
    same_losses = runs["world1"].losses == runs["one"].losses
    failures = []
    if bad or not same_losses or len(runs["one"].losses) != DP_ITERS:
        failures.append(f"dp train --num_devices 1: differs from the run "
                        f"without it (losses equal {same_losses}; "
                        f"{bad[:5]})")
    samples = {}
    for label, extra in (("one", ["--device", str(dev)]),
                         ("world1", ["--num_devices", "1"])):
        out = os.path.join(root, f"samples_{label}")
        t0 = time.time()
        gen_cli.main([runs["one"].log_dir, "--synthetic", str(DP_GEN_MOLS),
                      "--end_idx", str(DP_GEN_MOLS), "--n_steps",
                      str(DP_GEN_STEPS), "--fast", "--engine", "pksf",
                      "--w_global", "0.3", "--out_dir", out, "--no_resume",
                      *extra])
        wall[f"generate_{label}"] = time.time() - t0
        samples[label] = [m.meta["pos_gen"] for m in load_samples(
            os.path.join(out, "samples_all.npz"))]
    same_samples = len(samples["one"]) == DP_GEN_MOLS and all(
        np.array_equal(a, b) for a, b in zip(samples["one"],
                                             samples["world1"]))
    if not same_samples:
        failures.append("dp generate --num_devices 1: samples differ from "
                        "the run without it")
    report["dp"]["world1"] = dict(train_equal=not bad and same_losses,
                                  generate_equal=same_samples, wall_s=wall)
    report["dp"]["log_dir"] = runs["one"].log_dir
    print(f"dp (a) world 1 over NCCL: cli/train.py {DP_ITERS} iterations "
          f"torch.equal to the run without --num_devices: losses "
          f"{same_losses}, checkpoint {not bad}; cli/generate.py 'pksf' "
          f"{DP_GEN_MOLS} molecules x {DP_GEN_STEPS} steps: samples equal "
          f"{same_samples}; wall s {json.dumps(wall)}", flush=True)
    return failures


def dp_train_cases(dev):
    """(b)'s train cases and the single-process card step of each config:
    {name: case}, {config label: reference step_result}."""
    import copy

    import torch

    from agdiff_torch.config import load_config
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import init_like_jax

    cases, refs = {}, {}
    for label, config in (
            ("f32", load_config(os.path.join(ROOT, "configs",
                                             TRAIN_CONFIG))),
            ("bf16", fast_config())):
        mols = synthetic_dataset(DP_MOLECULES, seed=config.train.seed)
        batch, t, noise = train_batch(config, mols[:int(len(mols) * 0.9)])
        init = init_like_jax(DualEncoderEpsNetwork(config.model),
                             torch.Generator().manual_seed(
                                 config.train.seed))
        refs[label] = train_step_on(config, copy.deepcopy(init), dev, batch,
                                    t, noise)
        base = dict(config=config, init=init.state_dict(), batch=batch, t=t,
                    noise=noise)
        cases[label] = base
        for fault in DP_FAULTS:
            cases[f"{label} fault {fault}"] = dict(base, fault=fault)
    return cases, refs


def dp_ladder_cases(qcfg, qmols, dcfg, dconf, dmols):
    """(b)'s ladders: one molecule repeated (the runner's chunk), QM9 at
    B=128 in bucket 32 ('pksf'), Drugs' 50-atom molecule at B=48 in
    bucket 64 ('tight-pksf'), starts and noise drawn here."""
    import torch

    from agdiff_torch.data.bucketing import pad_molecules

    gen = torch.Generator().manual_seed(SEED)
    cases = {}
    for engine, cfg, mol, bucket, b, buckets in (
            ("pksf", qcfg, qmols[0], 32, CHUNK, (32,)),
            ("tight-pksf", dcfg, dmols[0], 64, DRUGS_CHUNK, dconf.buckets)):
        batch = pad_molecules([mol] * b, bucket, batch_size=b)
        cases[engine] = dict(
            engine=engine, model_config=cfg, mol=mol, buckets=buckets,
            batch=batch, pos_init=torch.randn(batch.pos.shape, generator=gen),
            noise=torch.randn((DP_LADDER_STEPS,) + tuple(batch.pos.shape),
                              generator=gen))
    return cases


def dp_check_ladders(case, ranks_out, model, dev, report) -> list:
    """The gathered samples bit for bit against single-process runs at each
    rank's batch size on its noise slice, and within the engine's limit
    of the whole batch's run; each rank's K1 launches equal to its
    forwards, no other kernel. The references run the eager loop (the
    bits of the graphs the ranks replay, phase 7)."""
    import torch

    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion

    engine, cfg = case["engine"], case["model_config"]
    runner = GenerationRunner(
        model, cfg, make_diffusion(cfg), dp_ladder(),
        buckets=case["buckets"], chunk_size=case["batch"].num_graphs,
        device=dev, engine=engine, graph=False)
    sampler = runner._sampler(engine, False,
                              runner._capacity_for(case["mol"], engine))
    batch, pos_init, noise = (case["batch"].to(dev), case["pos_init"].to(dev),
                              case["noise"].to(dev))
    got = ranks_out[0]["ladders"][engine]
    b = batch.num_graphs // len(ranks_out)
    bitwise = []
    t0 = time.perf_counter()
    for r in range(len(ranks_out)):
        rows = slice(r * b, (r + 1) * b)
        alone = sampler(batch.replace(**{
            k: v[rows] for k, v in vars(batch).items()}), pos_init[rows],
            noise=noise[:, rows])
        bitwise.append(torch.equal(got["pos"][rows], alone.pos.cpu())
                       and torch.equal(got["flags"][rows],
                                       alone.nan_flags.cpu()))
    torch.cuda.synchronize(dev)
    half_ms = (time.perf_counter() - t0) * 1e3 / (
        DP_LADDER_STEPS * len(ranks_out))
    whole = sampler(batch, pos_init, noise=noise).pos.cpu()
    rel = float((got["pos"] - whole).abs().max()) / float(whole.abs().max())
    failures = []
    rows = []
    for r, out in enumerate(ranks_out):
        lad = out["ladders"][engine]
        launches = dict(lad["launches"])
        k1 = launches.pop("stack_packed/stack_full:" + (
            "tight" if engine.startswith("tight") else "triu"), 0)
        rows.append(dict(rank=r, k1_launches=k1, forwards=lad["forwards"],
                         other=launches, ms_per_step=lad["ms_per_step"],
                         graphs=lad["graphs"]))
        if k1 != lad["forwards"] or not k1 or launches:
            failures.append(f"dp {engine} rank {r}: K1 launches {k1}, "
                            f"forwards {lad['forwards']}, other {launches}")
        if not (torch.equal(lad["pos"], got["pos"])
                and torch.equal(lad["flags"], got["flags"])):
            failures.append(f"dp {engine} rank {r}: its gathered samples "
                            f"differ from rank 0's")
    if not all(bitwise):
        failures.append(f"dp {engine}: the gathered rows differ from the "
                        f"single-process runs at B={b} ({bitwise})")
    limit = DP_ENGINE_LIMITS[engine]
    if not rel <= limit:
        failures.append(f"dp {engine}: {rel:.3e} of the whole batch's run, "
                        f"limit {limit}")
    report["dp"]["ladders"][engine] = dict(
        ranks=rows, bitwise_at_rank_batch=bitwise, rel_to_whole=rel,
        limit=limit, single_ms_per_step_at_rank_batch=half_ms,
        flagged=int(got["flags"].sum()))
    print(f"dp (b) {engine}: B={batch.num_graphs} as {len(ranks_out)} x {b} "
          f"on card 0, {DP_LADDER_STEPS} steps: bit for bit with the "
          f"single-process runs at B={b} on the same noise {bitwise} "
          f"({int(got['flags'].sum())} flagged); "
          f"{rel:.3e} of the B={batch.num_graphs} run (limit {limit}); per "
          f"rank K1 launches / forwards "
          f"{[(x['k1_launches'], x['forwards']) for x in rows]}, ms/step "
          f"{[round(x['ms_per_step'], 3) for x in rows]} (one process at "
          f"B={b}: {half_ms:.3f}; two ranks share one card: not a scaling "
          f"figure)", flush=True)
    return failures


def run_data_parallel(qcfg, qmols, dcfg, dconf, dmols, dev, report):
    """Phase 12: (a) the CLIs at world size 1 over NCCL, (b) two gloo ranks
    on card 0: the train step (f32 and bf16, planted faults), the runner's
    ladders ('pksf', 'tight-pksf') and a served burst, (c) generation over
    NCCL on two cards where the machine has them. Returns (failures, K1
    launches of the triu and tight variants over the ranks)."""
    import shutil

    import torch

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.parallel import launch

    report["dp"] = {"ladders": {}}
    failures = dp_cli_world_one(dev, report)

    train_cases, refs = dp_train_cases(dev)
    ladder_cases = dp_ladder_cases(qcfg, qmols, dcfg, dconf, dmols)
    sets = []
    for k in range(2):
        path = os.path.join(OUT_DIR, "dp", f"qm9_{k}.npz")
        save_molecules(path, qmols[2 * k:2 * k + 2])
        sets.append(path)
    serve_case = dict(model_config=qcfg, sets=sets,
                      nodes=sorted({m.num_nodes for m in qmols}))
    t0 = time.time()
    ranks_out = launch(dp_card_world, 2, dict(
        train=train_cases, ladders=ladder_cases, serve=serve_case),
        device="cuda:0", backend="gloo")
    world_s = time.time() - t0

    lr = {"f32": train_cases["f32"]["config"].train.optimizer.lr}
    rows = {}
    for name, case in train_cases.items():
        label = name.split()[0]
        got = ranks_out[0]["train"][name]["step"]
        rows[name] = (step_errors(got, refs[label], lr["f32"])
                      if label == "f32" else bf16_step_errors(got,
                                                              refs[label]))
    report["dp"]["train"] = rows
    for label, limits in (("f32", STEP_LIMITS), ("bf16", BF16_STEP_LIMITS)):
        print_step_rows(
            f"dp (b) {label} train step over two gloo ranks on card 0 "
            f"against the single-process card step",
            {(k.split(" ", 1)[1] if " " in k else "dp_vs_single"): v
             for k, v in rows.items() if k.split()[0] == label},
            limits, failures)
    timing = {label: [dict(ms_per_step=r["train"][label]["ms_per_step"],
                           all_reduce_ms=r["train"][label]["all_reduce_ms"],
                           synced=r["train"][label]["collectives"])
                      for r in ranks_out] for label in ("f32", "bf16")}
    report["dp"]["train_timing"] = timing
    grad_mib = ranks_out[0]["train"]["f32"]["grad_bytes"] / 2 ** 20
    print(f"dp (b) train step ms per rank (B=64 as 2 x 32, two ranks "
          f"sharing card 0 over gloo, not a scaling figure): "
          f"{json.dumps(timing)}; the gradient all-reduce moves "
          f"{grad_mib:.2f} MiB ({report['card']})", flush=True)

    k1 = {"triu": 0, "tight": 0}
    models = {"pksf": dp_model(qcfg).to(dev).eval(),
              "tight-pksf": dp_model(dcfg).to(dev).eval()}
    for engine, case in ladder_cases.items():
        failures += dp_check_ladders(case, ranks_out, models[engine], dev,
                                     report)
        key = "tight" if engine.startswith("tight") else "triu"
        k1[key] += sum(r["k1_launches"] for r in
                       report["dp"]["ladders"][engine]["ranks"])

    serve = [r["serve"] for r in ranks_out]
    s0 = serve[0]
    burst_k1 = s0["burst_launches"].get("stack_packed/stack_full:triu", 0)
    other = {k: v for k, v in s0["burst_launches"].items()
             if k != "stack_packed/stack_full:triu"}
    if not (s0["warm_ok"] and all(s0["ok"]) and s0["merged"] >= 2
            and s0["stopped"]):
        failures.append(f"dp serve: warm {s0['warm_ok']}, ok {s0['ok']}, "
                        f"merged {s0['merged']}, stopped {s0['stopped']}")
    if burst_k1 != s0["burst_forwards"] or not burst_k1 or other \
            or s0["burst_captures"]:
        failures.append(f"dp serve rank 0: K1 {burst_k1}, forwards "
                        f"{s0['burst_forwards']}, other {other}, captures "
                        f"{s0['burst_captures']}")
    for r, out in enumerate(serve):
        k1_all = out["launches"].get("stack_packed/stack_full:triu", 0)
        k1["triu"] += k1_all
        if out["captures"] != out["pinned"] or k1_all != out["forwards"]:
            failures.append(f"dp serve rank {r}: {out['captures']} "
                            f"captures, {out['pinned']} warmed; K1 {k1_all}, "
                            f"forwards {out['forwards']}")
    report["dp"]["serve"] = serve
    lat = sorted(s0["latencies"])
    per_rank = [(o["launches"].get("stack_packed/stack_full:triu", 0),
                 o["forwards"]) for o in serve]
    print(f"dp (b) served burst over two ranks: {SERVE_REQUESTS} requests "
          f"ok {all(s0['ok'])}, merged {s0['merged']}, captures during the "
          f"burst {s0['burst_captures']}, captures / warmed ladders per "
          f"rank {[(o['captures'], o['pinned']) for o in serve]}, K1 "
          f"launches / forwards per rank {per_rank}, "
          f"latency p50 {lat[len(lat) // 2]:.3f} s max {lat[-1]:.3f} s, "
          f"burst {s0['wall_s']:.3f} s; the world {world_s:.1f} s",
          flush=True)

    if torch.cuda.device_count() >= 2:
        from agdiff_torch.cli import generate as gen_cli

        out = os.path.join(OUT_DIR, "dp", "samples_two_cards")
        t0 = time.time()
        gen_cli.main([report["dp"]["log_dir"], "--synthetic",
                      str(DP_GEN_MOLS), "--end_idx", str(DP_GEN_MOLS),
                      "--n_steps", str(DP_GEN_STEPS), "--fast", "--engine",
                      "pksf", "--w_global", "0.3", "--out_dir", out,
                      "--no_resume", "--num_devices", "2"])
        print(f"dp (c) cli/generate.py --num_devices 2 over NCCL: "
              f"{time.time() - t0:.1f} s", flush=True)
    else:
        print(f"dp (c) this machine has {torch.cuda.device_count()} card: "
              f"NCCL across two cards not run", flush=True)
    # the checkpoints (tens of MB each) are not kept; the logs are
    for d, subdirs, _ in os.walk(os.path.join(OUT_DIR, "dp")):
        if "checkpoints" in subdirs:
            shutil.rmtree(os.path.join(d, "checkpoints"))
    return failures, k1["triu"], k1["tight"]


# ---- phase 13: configuration variants ---------------------------------------

# gelu score heads (ModelConfig.mlp_act 'gelu'), the 'gaussian' edge
# encoder and the reference's .pkl test sets, each on the configs the
# earlier phases run, changed in code (dataclasses.replace)
VARIANT_LADDER = 50      # the gelu configs' 'pksf' / 'tight-pksf' runs
GAUSS_ITERS = 32         # cli/train.py iterations of the gaussian config
GAUSS_GEN_MOLS = 4       # held-out molecules it generates (module path)
PKL_STEPS = 50           # cli/generate.py --engine pksf on the .pkl set


def reference_pickle(path, mols):
    """`mols` as the reference's dataset pickle: a list of PyG 1.x Data,
    one per reference conformer, written with a stub
    torch_geometric.data.data.Data class (this machine has no
    torch_geometric; pickle needs the class importable to write it)."""
    import pickle
    import types

    import numpy as np
    import torch

    name = "torch_geometric.data.data"
    parts = name.split(".")
    for k in range(1, len(parts) + 1):
        sys.modules.setdefault(".".join(parts[:k]),
                               types.ModuleType(".".join(parts[:k])))
    data_cls = getattr(sys.modules[name], "Data", None)
    if data_cls is None:
        data_cls = type("Data", (), {"__module__": name,
                                     "__qualname__": "Data"})
        sys.modules[name].Data = data_cls
    out = []
    for i, m in enumerate(mols):
        for conf in m.pos_ref.reshape(-1, m.num_nodes, 3):
            d = data_cls()
            d.atom_type = torch.from_numpy(m.atom_type.astype(np.int64))
            d.pos = torch.from_numpy(np.ascontiguousarray(conf))
            d.edge_index = torch.from_numpy(m.bond_index.astype(np.int64))
            d.edge_type = torch.from_numpy(m.bond_type.astype(np.int64))
            d.smiles, d.idx = m.smiles, torch.tensor([i])
            out.append(d)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return len(out)


def run_variants(qcfg, dconf, fcfg, qmols, dmols, dev, gen, report, dump):
    """Phase 13: the gelu score heads through K1 (triu and tight, exact and
    '-approx'), K4 (f32, bf16) and K6 (bf16 QM9 and Drugs, f32 QM9)
    against their plain versions with planted faults, the gelu engines
    against the f32 engines and through the runner and the paths (K1, K4
    and K6 launches equal to forwards); the 'gaussian' encoder's train
    step against the CPU's, cli/train.py, cli/generate.py on the module
    path and cli/eval_covmat.py; a reference-layout .pkl test set through
    cli/generate.py --engine pksf and scored. Returns (failures, K1 rows
    by case, K4 rows by variant, K6 rows by case, launches by kernel
    line name). `dump` writes the report."""
    import shutil

    import numpy as np
    import torch

    from agdiff_torch.cli import generate as gen_cli
    from agdiff_torch.cli import train as train_cli
    from agdiff_torch.config import load_config
    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.eval.generate import GenerationRunner, load_samples
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.models.reference_checkpoint import (
        export_reference_state_dict,
    )
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.models.tight_forward import build_tight_forward
    from agdiff_torch.models.weights import init_random
    from agdiff_torch.ops.pairs import pair_capacity_for
    from agdiff_torch.sampling.langevin import SamplerConfig

    failures, k1_rows, mono_rows, launches = [], {}, {}, {}
    dcfg = dconf.model
    gelu = {k: dataclasses.replace(c, mlp_act="gelu")
            for k, c in (("qm9", qcfg), ("drugs", dcfg), ("f32", fcfg))}
    models = {k: init_random(DualEncoderEpsNetwork(c), SEED).to(dev).eval()
              for k, c in gelu.items()}

    # (a) K1 with gelu heads: triu at QM9 B=128 N=32 and tight at Drugs
    # B=48 N=64, exact and '-approx', at the wrapper's R and R = 1 (and 2),
    # every layout level
    for label, key, engine, mols, n, b in (
            ("gelu_triu_B128_N32", "qm9", "pksf", qmols, 32, CHUNK),
            ("gelu_approx_triu_B128_N32", "qm9", "pksf-approx", qmols, 32,
             CHUNK),
            ("gelu_tight_B48_N64", "drugs", "tight-pksf", dmols[:1], 64,
             DRUGS_CHUNK),
            ("gelu_approx_tight_B48_N64", "drugs", "tight-pksf-approx",
             dmols[:1], 64, DRUGS_CHUNK)):
        tight = engine.startswith("tight")
        build = build_tight_forward if tight else build_fast_forward
        fwd = build(gelu[key], models[key], engine)
        batch = random_batch(mols, n, b, gen)
        pairs = (fwd.prepare(batch, pair_capacity_for(mols[0].num_nodes,
                                                      256))
                 if tight else None)
        kw, _ = fwd.stack_inputs(batch, pairs)
        limits = DRUGS_LIMITS if tight else QM9_LIMITS
        # no CPU run of the plain version: phase 3 reads that scale for
        # relu, and the heads change nothing upstream of them
        k1_rows[label], failed = check_k1(
            kw, batch.node_mask, label, "full", fwd.approx, limits, None,
            report, (1, 2))
        failures += failed
        failures += check_levels(kw, label, report, fwd.approx)
        if fwd.approx:
            # the heads' inputs moved into the band where the two gelu
            # forms differ, so that the exact-gelu fault shows
            failures += check_k1(
                head_band(kw, True), batch.node_mask, f"{label}_head_band",
                "full", True, limits, None, report, band=True)[1]
    dump()

    # (b) K4 with gelu on the global and local heads' inputs of engine
    # 'pallas' with pack_pairs=False, f32 (qm9_default) and bf16 (qm9_fast)
    dense = {"C-gelu": build_fast_forward(gelu["f32"], models["f32"],
                                          "pallas", pack_pairs=False),
             "C-bf16-gelu": build_fast_forward(gelu["qm9"], models["qm9"],
                                               "pallas", pack_pairs=False)}
    qbatch = random_batch(qmols, 32, CHUNK, gen)

    def limits_for(names, dtype):
        lim = (F32_KERNEL_LIMITS if dtype == torch.float32
               else BF16_KERNEL_LIMITS)
        return {nm: (OFF_MASK_LIMITS if nm == "off_mask" else lim)
                for nm in names}

    k4_rows = {}
    for label, fwd in dense.items():
        k4_rows.update(check_k4(label, fwd, qbatch, limits_for, report,
                                failures, cases=("global", "local")))

    # (c) K6 with gelu heads: bf16 QM9 and Drugs, f32 QM9 (MONO_LIMITS)
    for label, key, mols, n, b, limits in (
            ("gelu_bf16_B128_N32", "qm9", qmols, 32, CHUNK, "bf16"),
            ("gelu_bf16_B48_N64", "drugs", dmols[:1], 64, DRUGS_CHUNK,
             "bf16_drugs"),
            ("gelu_f32_B128_N32", "f32", qmols, 32, CHUNK, "f32")):
        batch = random_batch(mols, n, b, gen)
        batch = batch.replace(pos=batch.pos * MONO_POS_SCALE)
        kw, _ = build_monolithic_forward(gelu[key],
                                         models[key]).kernel_inputs(batch)
        mono_rows[label], failed = check_k6(kw, label, MONO_LIMITS[limits],
                                            report)
        failures += failed
    dump()

    # (d) the gelu engines against the f32 engines, then through the
    # runner (graphed) with K1 launches equal to forwards
    small = pad_molecules(qmols, 32, device=dev)
    one = pad_molecules([dmols[0]] * 4, 64, device=dev)
    f32_q = build_fast_forward(gelu["qm9"], models["qm9"], None)(small)
    for engine in ("pksf", "pksf-approx"):
        check_engines(build_fast_forward(gelu["qm9"], models["qm9"],
                                         engine)(small), f32_q,
                      f"gelu {engine}", ENGINE_TOL, report)
    f32_d = build_tight_forward(gelu["drugs"], models["drugs"], "tight")(one)
    for engine in ("tight-pksf", "tight-pksf-approx"):
        check_engines(build_tight_forward(gelu["drugs"], models["drugs"],
                                          engine)(one), f32_d,
                      f"gelu {engine}", DRUGS_ENGINE_TOL, report)
    f32_f = build_fast_forward(gelu["f32"], models["f32"], None)(small)
    check_engines(dense["C-gelu"](small), f32_f, "gelu pallas_f32_dense",
                  F32_ENGINE_TOL, report)
    check_engines(dense["C-bf16-gelu"](small), f32_q,
                  "gelu pallas_bf16_dense", ENGINE_TOL, report)
    for label, key, engine, mols, steps, chunk, buckets, name in (
            ("gelu_qm9", "qm9", "pksf", qmols, VARIANT_LADDER, CHUNK, (32,),
             "stack_full_gelu:triu"),
            ("gelu_qm9_approx", "qm9", "pksf-approx", qmols, VARIANT_STEPS,
             CHUNK, (32,), "stack_full_gelu_approx:triu"),
            ("gelu_drugs", "drugs", "tight-pksf", dmols[:1], VARIANT_LADDER,
             DRUGS_CHUNK, dconf.buckets, "stack_full_gelu:tight"),
            ("gelu_drugs_approx", "drugs", "tight-pksf-approx", dmols[:1],
             VARIANT_STEPS, DRUGS_CHUNK, dconf.buckets,
             "stack_full_gelu_approx:tight")):
        runner = GenerationRunner(
            models[key], gelu[key], make_diffusion(gelu[key]),
            SamplerConfig(n_steps=steps, w_global=0.3), buckets=buckets,
            chunk_size=chunk, device=dev, engine=engine)
        row = run_slice(runner, engine, mols, chunk, label, report)
        launches[name] = row["k1_launches"]

    # (e) paths C and C-bf16 with gelu heads (K4 2 a forward) and E with
    # gelu heads (K6 1 a forward)
    fdiff = make_diffusion(gelu["f32"])
    for label, dt, k3 in (("C-gelu", "f32", {("fused", "block_agg:f32"): 6,
                                             ("fused", "gine:f32"): 4}),
                          ("C-bf16-gelu", "bf16",
                           {("fused", "block_agg:bf16"): 6})):
        row = run_path(label, dense[label], fdiff, qmols, SHORT_STEPS,
                       {**k3, ("fused", f"pair_score_gelu:{dt}"): 2},
                       report, num_confs=CHUNK)
        launches[f"pair_score_gelu:{dt}"] = row["launches"][
            f"fused/pair_score_gelu:{dt}"]
    for label, key, dt in (("E-gelu", "qm9", "bf16"),
                           ("E-f32-gelu", "f32", "f32")):
        runner = GenerationRunner(
            models[key], gelu[key], make_diffusion(gelu[key]),
            SamplerConfig(n_steps=SHORT_STEPS, w_global=0.3),
            buckets=(32,), chunk_size=CHUNK, device=dev, engine="mono")
        row = run_path(label, runner.forward("mono"), runner.diffusion,
                       qmols, SHORT_STEPS, {("monolithic",
                                             f"mono_gelu:{dt}"): 1},
                       report, runner=runner, num_confs=CHUNK)
        launches[f"mono_gelu:{dt}"] = row["launches"][
            f"monolithic/mono_gelu:{dt}"]
    dump()

    # (f) the 'gaussian' encoder on configs/synthetic_qm9.yml: the train
    # step against the CPU's (STEP_LIMITS, with the phase 9 faults), then
    # cli/train.py, cli/generate.py on the module path (no --fast: the
    # fast engines refuse the encoder) and cli/eval_covmat.py
    root = os.path.join(OUT_DIR, "variants")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tconf = load_config(os.path.join(ROOT, "configs", TRAIN_CONFIG))
    gconf = dataclasses.replace(tconf, model=dataclasses.replace(
        tconf.model, edge_encoder="gaussian"))
    mols = synthetic_dataset(TRAIN_MOLECULES, seed=tconf.train.seed)
    failures += check_train_step(gconf, mols[:int(len(mols) * 0.9)], dev,
                                 report, "gaussian train step",
                                 "gaussian_step_checks")
    cfg_path = write_train_config(os.path.join(root, "gaussian.yml"),
                                  model={"edge_encoder": "gaussian"},
                                  max_iters=GAUSS_ITERS,
                                  val_freq=GAUSS_ITERS)
    t0 = time.time()
    run = train_cli.main([cfg_path, "--logdir", os.path.join(root, "logs"),
                          "--synthetic", str(TRAIN_MOLECULES), "--device",
                          str(dev)])
    train_s = time.time() - t0
    losses = np.asarray(run.losses)
    out = os.path.join(root, "gaussian_samples")
    for c in kernel_counters().values():
        c.clear()
    t0 = time.time()
    gen_cli.main([run.log_dir, "--synthetic", str(GAUSS_GEN_MOLS),
                  "--end_idx", str(GAUSS_GEN_MOLS), "--n_steps",
                  str(TRAIN_GEN_STEPS), "--w_global", "0.3", "--out_dir",
                  out, "--no_resume", "--device", str(dev)])
    gen_s = time.time() - t0
    kernels_run = launch_counts()
    gsamples = os.path.join(out, "samples_all.npz")
    done = load_samples(gsamples)
    finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in done)
    # scored in a subprocess beside (g), finished after it
    gscoring = start_scoring(gsamples)
    row = dict(iterations=len(losses), train_s=train_s,
               losses_finite=bool(np.isfinite(losses).all()),
               loss_first=float(losses[0]), loss_last=float(losses[-1]),
               generated=len(done), gen_s=gen_s, finite=finite,
               kernel_launches=kernels_run)
    report["variants"] = {"gaussian": row}
    print(f"gaussian: cli/train.py {len(losses)} iterations in "
          f"{train_s:.1f} s (losses finite {row['losses_finite']}, "
          f"{row['loss_first']:.3f} -> {row['loss_last']:.3f}); "
          f"cli/generate.py on the module path: {len(done)} molecules, "
          f"{TRAIN_GEN_STEPS} steps in {gen_s:.1f} s, finite {finite}, hand "
          f"kernel launches {kernels_run}", flush=True)
    if len(losses) != GAUSS_ITERS or not row["losses_finite"] \
            or len(done) != GAUSS_GEN_MOLS or not finite or kernels_run:
        failures.append(f"gaussian: {row}")
    shutil.rmtree(os.path.join(run.log_dir, "checkpoints"),
                  ignore_errors=True)

    # (g) the synthetic QM9 test set as a reference-layout .pkl through
    # cli/generate.py --fast --engine pksf (a reference .pt of the seeded
    # qm9_fast model), then scored
    qset = test_sets()[0]
    pkl = os.path.join(root, "qm9_test.pkl")
    entries = reference_pickle(pkl, qset)
    ckpt = os.path.join(root, "model.pt")
    qmodel = init_random(DualEncoderEpsNetwork(qcfg), SEED)
    torch.save({"model": export_reference_state_dict(qmodel),
                "config": {"model": dataclasses.asdict(qcfg)}}, ckpt)
    out = os.path.join(root, "pkl_samples")
    for c in kernel_counters().values():
        c.clear()
    t0 = time.time()
    gen_cli.main([ckpt, "--test_set", pkl, "--fast", "--engine", "pksf",
                  "--n_steps", str(PKL_STEPS), "--w_global", "0.3",
                  "--clip_local", "20", "--out_dir", out, "--no_resume",
                  "--device", str(dev)])
    gen_s = time.time() - t0
    k1_runs = sum(n for k, n in launch_counts().items()
                  if k.startswith("stack_packed/"))
    samples = os.path.join(out, "samples_all.npz")
    done = load_samples(samples)
    finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in done)
    shapes = all(g.meta["pos_gen"].shape == (2 * 3, m.num_nodes, 3)
                 and np.array_equal(g.atom_type, m.atom_type)
                 for g, m in zip(done, qset))
    failures += finish_scoring("qm9_gaussian", gscoring, gsamples,
                               GAUSS_GEN_MOLS, report)
    failures += finish_scoring("qm9_pkl", start_scoring(samples), samples,
                               len(qset), report)
    report["variants"]["pkl"] = dict(
        molecules=len(done), entries=entries, steps=PKL_STEPS, wall_s=gen_s,
        k1_launches=k1_runs, finite=finite, shapes=shapes)
    print(f"pkl: {len(qset)} molecules as {entries} PyG Data entries, "
          f"cli/generate.py --engine pksf {PKL_STEPS} steps: {len(done)} "
          f"molecules in {gen_s:.1f} s (K1 launches {k1_runs}), finite "
          f"{finite}, shapes and atoms {shapes}", flush=True)
    if len(done) != len(qset) or not finite or not shapes or not k1_runs:
        failures.append(f"pkl: {report['variants']['pkl']}")
    return failures, k1_rows, k4_rows, mono_rows, launches


# ---- phase 14: sharded and pipelined on the card ---------------------------

# (a) the sharded steps over two gloo ranks on card 0, each held against
# the single-process card step under phase 9's limits (f32) with the
# gradient norm to JAX's sharded test's rtol 1e-4
# (tests/test_sharded_parallel.py:92), or phase 11's (bf16)
SHARD_LIMITS = dict(STEP_LIMITS, grad_norm_rel=1e-4)
SHARD_MODES = ("fsdp", "tp")
SHARD_FAULTS = (("shard_unsummed", "fsdp"), ("partial_unreduced", "tp"),
                ("own_shard_norm", "fsdp"))
SHARD_STATE_SHARE = 0.55  # a rank's bytes of the state at most, of the whole
SHARD_TIMED_STEPS = 2
SPEC_FIXTURE = os.path.join(ROOT, "tests", "torch_port_jax_specs.json")
SPEC_CONFIGS = (TRAIN_CONFIG, FAST_CONFIG)
# (c) schnet_pipeline on qm9_fast.yml: six blocks in two stages of three,
# a QM9 batch of B=128 at N=32 as M=4 microbatches of 32 graphs
PIPE_STAGES, PIPE_MICRO, PIPE_B = 2, 4, 128
PIPE_TIMED = 3
# (d) the gradient through the pipeline: M=4 microbatches of 8 graphs
GRAD_PIPE_B = 32


@contextlib.contextmanager
def shard_fault(name):
    """A planted fault of a sharded step: an fsdp gradient shard left
    unsummed (the gather's backward keeps the rank's own row), a
    row-parallel partial product left unreduced, the clip's norm taken
    from the rank's own shards; of the pipeline: the outputs rotated two
    stages on instead of one."""
    from agdiff_torch.parallel.mesh import Mesh, with_adjoint
    from agdiff_torch.train.optimizer import TwoAdams, global_norm

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "shard_unsummed":
        patch(Mesh, "all_gather_with_grad", lambda self, x: with_adjoint(
            x, self.all_gather, lambda g: g[self.rank].clone()))
    elif name == "partial_unreduced":
        patch(Mesh, "sum_replicated", lambda self, x: x.clone())
    elif name == "own_shard_norm":
        patch(TwoAdams, "norm", lambda self, grads: global_norm(grads))
    elif name == "wrong_neighbour":
        real = Mesh.ppermute_with_grad
        patch(Mesh, "ppermute_with_grad", lambda self, x, perm: real(
            self, x, [(s, (s + 2) % self.world_size) for s, _ in perm]))
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def port_specs(config, axis, fault=False) -> dict:
    """The port's specs of a whole state of `config` over a ('dp', axis)
    mesh of model size 2, by collection/flax path; with `fault`, taken on
    the port's (out, in) shapes."""
    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.weights import flax_leaf
    from agdiff_torch.parallel import sharded
    from agdiff_torch.parallel.mesh import Mesh
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState

    module = DualEncoderEpsNetwork(config.model)
    state = TrainState(step=0, module=module,
                       optimizer=make_optimizer(module, config.train),
                       generator=torch.Generator())
    mesh = Mesh(2, 0, torch.device("cpu"), "gloo", axis_names=("dp", axis),
                dims=(1, 2))
    real = sharded.leaf_shape
    if fault:
        sharded.leaf_shape = lambda m, n, t: tuple(t.shape)
    try:
        specs = sharded.state_specs(state, mesh, axis)
    finally:
        sharded.leaf_shape = real
    out = {}
    for name, spec in specs.items():
        coll, path = flax_leaf(module, name)
        out["/".join((coll,) + path)] = list(spec)
    return out


def check_specs(report) -> list:
    """(a) the port's specs of both configs' states against JAX's, from
    the fixture the CPU tests write and check
    (tests/test_torch_port_sharded.py); the specs taken on the port's
    shapes must differ."""
    from agdiff_torch.config import load_config

    with open(SPEC_FIXTURE) as f:
        fixture = json.load(f)
    failures, rows = [], {}
    for name in SPEC_CONFIGS:
        config = load_config(os.path.join(ROOT, "configs", name))
        for axis in SHARD_MODES:
            got = port_specs(config, axis)
            want = fixture[name][axis]
            off = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            rows[f"{name} {axis}"] = dict(
                leaves=len(want), sharded=sum(bool(s) for s in want.values()),
                differ=len(off))
            if off or not want:
                failures.append(f"specs {name} {axis}: {len(off)} leaves "
                                f"differ from JAX's, e.g. {off[:3]}")
        wrong = port_specs(config, "fsdp", fault=True)
        differ = sum(wrong.get(k) != v
                     for k, v in fixture[name]["fsdp"].items())
        rows[f"{name} fault port_shape"] = dict(differ=differ)
        if not differ:
            failures.append(f"specs {name}: specs on the port's shapes "
                            f"equal JAX's")
    report["sharded"]["specs"] = rows
    print(f"sharded (a) specs against JAX's (tests/torch_port_jax_specs."
          f"json): {json.dumps(rows)}", flush=True)
    return failures


def shard_rank(group, case) -> dict:
    """(a) one sharded step of the case's initial weights on a (1, 2)
    mesh of the world ('dp', mode), this rank's rows of the batch, the
    global t and noise, a planted fault when the case names one:
    step_result's tuple over the whole state (gather_state), this rank's
    bytes of the state; a sound step also times SHARD_TIMED_STEPS steps
    and the all-gather and reduce-scatter of its sharded parameters."""
    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.parallel import sharded
    from agdiff_torch.parallel.mesh import make_hybrid_mesh
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState, ema_copy

    config, mode, dev = case["config"], case["mode"], group.device
    mesh = make_hybrid_mesh(2, 2, model_axis=mode)
    module = DualEncoderEpsNetwork(config.model)
    module.load_state_dict(case["init"])
    module = module.to(dev)
    state = TrainState(
        step=0, module=module, optimizer=make_optimizer(module, config.train),
        generator=torch.Generator(device=dev).manual_seed(0),
        ema=ema_copy(module) if config.train.ema_decay > 0 else None)
    before = {n: p.detach().cpu().clone()
              for n, p in module.named_parameters()}
    sharded.shard_train_state(state, mesh, mode)
    step = sharded.make_sharded_train_step(config, mesh, state, mode)
    axes = mesh.axis_names if mode == "fsdp" else ("dp",)
    shard = sharded.shard_graph_batch_over(case["batch"], mesh, axes)
    with shard_fault(case.get("fault")):
        metrics = step(state, shard, case["t"].to(dev),
                       case["noise"].to(dev))
    whole = sharded.gather_state(state)
    out = {"step": ({k: float(v) for k, v in metrics._asdict().items()},
                    {n: g.cpu() for n, g in whole["grads"].items()},
                    {n: b.cpu() for n, b in whole["buffers"].items()},
                    before,
                    {n: p.cpu() for n, p in whole["params"].items()}),
           "bytes": state.layout.rank_bytes(state), "rows": shard.num_graphs}
    if case.get("fault") is None:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(SHARD_TIMED_STEPS):
            step(state, shard)
        torch.cuda.synchronize(dev)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
            / SHARD_TIMED_STEPS
        line, opt = state.layout.line, state.optimizer
        flat = torch.cat([p.detach().reshape(-1) for p, s in
                          zip(opt.params, opt.sharded) if s])
        rows = line.all_gather(flat)
        for key, fn in (("all_gather_ms", lambda: line.all_gather(flat)),
                        ("reduce_scatter_ms",
                         lambda: line.reduce_scatter(rows))):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(SHARD_TIMED_STEPS):
                fn()
            torch.cuda.synchronize(dev)
            out[key] = (time.perf_counter() - t0) * 1e3 / SHARD_TIMED_STEPS
        out["gathered_mib"] = rows.numel() * 4 / 2 ** 20
    return out


def pipe_payload(fwd, batch):
    """(h, e, el, env) of a batch as PallasForward.__call__ makes them
    ahead of its SchNet blocks: the embedding, the dense edge features at
    the compute dtype, the distances and the envelope on the edge mask."""
    from agdiff_torch.nn.schnet import embed_max_norm, envelope
    from agdiff_torch.ops.graph import working_graph

    cfg = fwd.config
    dist, edge_mask, edge_type, _ = working_graph(
        batch, cfg.cutoff, cfg.edge_order)
    pairs = fwd.prepare(batch)
    _, _, e, _ = fwd.encode_edges(dist, edge_type, pairs)
    env = envelope(dist, cfg.cutoff, cfg.smooth_conv) * edge_mask
    h = embed_max_norm(fwd.schnet_emb, batch.atom_type,
                       cfg.embedding_max_norm).float()
    return h, e, dist[..., None], env.float()


def microbatches(payload, m):
    """Each tensor of the payload split along the batch into m
    microbatches, stacked on a new leading axis."""
    return tuple(a.reshape((m, a.shape[0] // m) + tuple(a.shape[1:]))
                 for a in payload)


def stage_sequence(stage, stacked, payload, stages):
    """The stage bodies one after another on each microbatch of `payload`
    ((M, ...) tensors): the stacked h."""
    import torch

    from agdiff_torch.parallel.pipeline import stage_slice

    out = []
    for m in range(payload[0].shape[0]):
        p = tuple(a[m] for a in payload)
        for s in range(stages):
            p = stage(stage_slice(stacked, s), p)
        out.append(p[0])
    return torch.stack(out)


def pipe_rank(group, case) -> dict:
    """(c) schnet_pipeline on the forward over the world's 'pp' axis: the
    pipelined h of the payload (the second of two runs, its launches by
    kernel counted from 0 just before it), ms per forward, and the
    rotation fault's h. (d) the gradient of sum(h * proj) through
    pipeline_apply on the plain stage body, in the stacked block
    parameters (each rank its stage's, summed over the ranks) and in the
    input h."""
    import torch
    from torch.utils._pytree import tree_leaves, tree_map

    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.parallel import pipeline

    dev = group.device
    mesh = pipeline.make_pp_mesh(2)
    out = {}
    fwd = build_fast_forward(case["config"], dp_model(case["config"]).to(
        dev).eval(), "pallas")
    run, stacked = pipeline.schnet_pipeline(fwd, mesh)
    payload = tuple(a.to(dev) for a in case["payload"])
    with torch.no_grad():
        run(stacked, payload)
        torch.cuda.synchronize(dev)
        zero_counts()
        h = run(stacked, payload)
        torch.cuda.synchronize(dev)
        out["launches"] = launch_counts()
        t0 = time.perf_counter()
        for _ in range(PIPE_TIMED):
            run(stacked, payload)
        torch.cuda.synchronize(dev)
        out["ms_per_forward"] = (time.perf_counter() - t0) * 1e3 / PIPE_TIMED
        with shard_fault("wrong_neighbour"):
            out["wrong"] = run(stacked, payload).cpu()
    out["h"] = h.cpu()
    # (d)
    gfwd = build_fast_forward(case["grad_config"], dp_model(
        case["grad_config"]).to(dev).eval(), "pallas")
    grun, gstacked = pipeline.schnet_pipeline(gfwd, mesh)
    gstacked = tree_map(lambda a: a.clone().requires_grad_(True), gstacked)
    gpay = tuple(a.to(dev) for a in case["grad_payload"])
    h0 = gpay[0].clone().requires_grad_(True)
    hp = grun(gstacked, (h0,) + gpay[1:])
    (hp * case["proj"].to(dev)).sum().backward()
    out["grads"] = [group.all_reduce(a.grad.clone()).cpu()
                    for a in tree_leaves(gstacked)] + [h0.grad.cpu()]
    return out


def shard_card_world(group, cases) -> list:
    """Phase 14 (a) and (c)-(d) in each of two gloo ranks on card 0."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"shard": {k: shard_rank(group, c)
                     for k, c in cases["shard"].items()},
           "pipe": pipe_rank(group, cases["pipe"])}
    return dp_every_rank(group, out)


def dcn_card_world(group, cases) -> list:
    """Phase 14 (b) in each of four gloo ranks on card 0: the DP step
    over the ('dcn', 'dp') = (2, 2) mesh, the flat 4-rank DP step, and
    the cross-slice fault."""
    import torch

    from agdiff_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dcn = make_mesh(4, dcn_slices=2)
    out = {name: dp_train_rank(group if name == "flat" else dcn, case)
           for name, case in cases.items()}
    return dp_every_rank(group, out)


def shard_rows(cases, ranks_out, refs, lr) -> dict:
    """{case: the f32 or bf16 step row of rank 0's whole state against
    the single-process card step}, the f32 rows with the gradient
    norm."""
    rows = {}
    for name, case in cases.items():
        got = ranks_out[0]["shard"][name]["step"]
        label = case["label"]
        if label == "f32":
            row = step_errors(got, refs[label], lr)
            want = refs[label][0]["grad_norm"]
            row["grad_norm_rel"] = abs(got[0]["grad_norm"] - want) / want
            row["broken"] = [k for k, lim in SHARD_LIMITS.items()
                             if not row[k] <= lim]
        else:
            row = bf16_step_errors(got, refs[label])
        rows[name] = row
    return rows


def run_sharded(qcfg, qmols, dev, gen, report, train_cases):
    """Phase 14: (a) fsdp and tp train steps on two gloo ranks on card 0
    against the single-process step, with planted faults, each rank's
    bytes of the state, and the specs against JAX's; (b) the ('dcn',
    'dp') DP step on four ranks against the single and the flat 4-rank
    steps; (c) schnet_pipeline through K3 on two ranks against the
    sequential K3 stack and K3's plain version; (d) a gradient through
    the pipeline. `train_cases` is dp_train_cases' (cases, card
    references). Returns (failures, K3 bf16 launches of the pipelined
    forward over the ranks)."""
    import torch
    from torch.utils._pytree import tree_leaves, tree_map

    from agdiff_torch.config import load_config
    from agdiff_torch.kernels import fused
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.parallel import launch, pipeline

    report["sharded"] = {}
    card = report["card"]
    failures = check_specs(report)

    # (a) and (c)-(d): one world of two ranks
    train_cases, refs = train_cases
    shard_cases = {}
    for label in ("f32", "bf16"):
        base = {k: train_cases[label][k]
                for k in ("config", "init", "batch", "t", "noise")}
        for mode in SHARD_MODES:
            shard_cases[f"{label} {mode}"] = dict(base, label=label,
                                                  mode=mode)
    for fault, mode in SHARD_FAULTS:
        shard_cases[f"f32 fault {fault} ({mode})"] = dict(
            shard_cases[f"f32 {mode}"], fault=fault)
    fwd = build_fast_forward(qcfg, dp_model(qcfg).to(dev).eval(), "pallas")
    with torch.no_grad():
        payload = microbatches(pipe_payload(fwd, random_batch(
            qmols, 32, PIPE_B, gen)), PIPE_MICRO)
    gcfg = load_config(os.path.join(ROOT, "configs", TRAIN_CONFIG)).model
    gfwd = build_fast_forward(gcfg, dp_model(gcfg).to(dev).eval(), "pallas")
    with torch.no_grad():
        gpay = microbatches(pipe_payload(gfwd, random_batch(
            qmols, 32, GRAD_PIPE_B, gen)), PIPE_MICRO)
    proj = torch.randn(gpay[0].shape, generator=gen, device=dev)
    pipe_case = dict(config=qcfg, payload=tuple(a.cpu() for a in payload),
                     grad_config=gcfg,
                     grad_payload=tuple(a.cpu() for a in gpay),
                     proj=proj.cpu())
    t0 = time.time()
    ranks_out = launch(shard_card_world, 2, dict(
        shard=shard_cases, pipe=pipe_case), device="cuda:0", backend="gloo")
    world_s = time.time() - t0

    lr = train_cases["f32"]["config"].train.optimizer.lr
    rows = shard_rows(shard_cases, ranks_out, refs, lr)
    report["sharded"]["steps"] = rows
    for label, limits in (("f32", SHARD_LIMITS), ("bf16", BF16_STEP_LIMITS)):
        print_step_rows(
            f"sharded (a) {label} train step over two gloo ranks on card 0 "
            f"against the single-process card step",
            {k.split(" ", 1)[1]: v for k, v in rows.items()
             if k.split()[0] == label}, limits, failures)
    shares, timing = {}, {}
    for name in shard_cases:
        if "fault" in name:
            continue
        per = [r["shard"][name] for r in ranks_out]
        shares[name] = [p["bytes"][0] / p["bytes"][1] for p in per]
        timing[name] = [dict(ms_per_step=p["ms_per_step"],
                             all_gather_ms=p["all_gather_ms"],
                             reduce_scatter_ms=p["reduce_scatter_ms"],
                             gathered_mib=p["gathered_mib"],
                             rows=p["rows"]) for p in per]
        if not all(s <= SHARD_STATE_SHARE for s in shares[name]):
            failures.append(f"sharded {name}: a rank holds "
                            f"{shares[name]} of the state's bytes")
        for r, p in enumerate(per):
            b = p["bytes"]
            print(f"sharded (a) {name} rank {r}: {b[0] / 2 ** 20:.2f} MiB "
                  f"of the state's {b[1] / 2 ** 20:.2f} MiB "
                  f"({b[0] / b[1]:.4f}, at most {SHARD_STATE_SHARE})",
                  flush=True)
    report["sharded"]["state_share"] = shares
    report["sharded"]["timing"] = timing
    print(f"sharded (a) ms per rank (two ranks sharing card 0 over gloo, "
          f"not a scaling figure): {json.dumps(timing)} ({card})",
          flush=True)

    # (c) the pipeline through K3
    stage = pipeline.schnet_stage(fwd)
    _, stacked = pipeline.schnet_pipeline(fwd, _pp_view())
    with torch.no_grad():
        seq = stage_sequence(stage, stacked, payload, PIPE_STAGES)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(PIPE_TIMED):
            stage_sequence(stage, stacked, payload, PIPE_STAGES)
        torch.cuda.synchronize(dev)
        seq_ms = (time.perf_counter() - t0) * 1e3 / PIPE_TIMED
        k3_rows, plain_seq = pipe_plain_checks(fwd, stage, stacked, payload)
    per = [r["pipe"] for r in ranks_out]
    k3 = fused.variant("block_agg", fwd.compute_dtype)
    want = PIPE_STAGES * (PIPE_MICRO + PIPE_STAGES - 1) * (
        len(fwd.blocks) // PIPE_STAGES)
    launched = sum(p["launches"].get(f"fused/{k3}", 0) for p in per)
    other = [{k: v for k, v in p["launches"].items() if k != f"fused/{k3}"}
             for p in per]
    got = per[0]["h"].to(dev)
    same = [torch.equal(p["h"].to(dev), seq) for p in per]
    end_to_end = errors(got, plain_seq)
    wrong_same = torch.equal(per[0]["wrong"].to(dev), seq)
    report["sharded"]["pipeline"] = dict(
        torch_equal=same, k3_launches=launched, k3_expected=want,
        other_launches=other, per_block=k3_rows, h_against_plain=end_to_end,
        ms_per_forward=[p["ms_per_forward"] for p in per],
        sequential_ms=seq_ms, fault_wrong_neighbour_equal=wrong_same)
    if not all(same):
        failures.append(f"pipeline (c): h not torch.equal to the sequential "
                        f"K3 stack on ranks {same}")
    if launched != want or any(other):
        failures.append(f"pipeline (c): K3 {launched} launches (want "
                        f"{want}), others {other}")
    k3_limits = (BF16_KERNEL_LIMITS if fwd.compute_dtype == torch.bfloat16
                 else F32_KERNEL_LIMITS)
    for blk, row in k3_rows.items():
        broken = [k for k, lim in k3_limits.items() if not row[k] <= lim]
        if broken:
            failures.append(f"pipeline (c) K3 against its plain version at "
                            f"{blk}: {broken}")
    if wrong_same:
        failures.append("pipeline (c): the wrong-neighbour rotation gives "
                        "the sequential stack's h")
    print(f"pipeline (c) schnet_pipeline on qm9_fast.yml (6 blocks, 2 stages, "
          f"B={PIPE_B} as {PIPE_MICRO} x {PIPE_B // PIPE_MICRO}): torch.equal "
          f"to the sequential K3 stack {same}; K3 launches {launched} "
          f"(S x (M + S - 1) x blocks / S = {want}), others {other}; K3 "
          f"against its plain version per block (max_rel, median_rel, "
          f"p99_rel) {[(round(r['max_rel'], 7), r['median_rel'], r['p99_rel']) for r in k3_rows.values()]}; "
          f"h after six blocks against the plain stack: max_rel "
          f"{end_to_end['max_rel']:.2e} median_rel "
          f"{end_to_end['median_rel']:.2e}; fault wrong_neighbour equal "
          f"{wrong_same}; ms per pipelined forward per rank "
          f"{[round(p['ms_per_forward'], 3) for p in per]} against the "
          f"sequential stack on one rank {seq_ms:.3f} ({card})", flush=True)

    # (d) the gradient through the pipeline against the sequential stack
    gstage = pipeline.schnet_stage(gfwd)
    _, gstacked = pipeline.schnet_pipeline(gfwd, _pp_view())
    gstacked = tree_map(lambda a: a.clone().requires_grad_(True), gstacked)
    h0 = gpay[0].clone().requires_grad_(True)
    hs = stage_sequence(gstage, gstacked, (h0,) + gpay[1:], PIPE_STAGES)
    (hs * proj).sum().backward()
    ref = [a.grad for a in tree_leaves(gstacked)] + [h0.grad]
    gots = per[0]["grads"]
    top = max(float(g.abs().max()) for g in ref)
    worst = {"grad_max_rel": 0.0, "grad_median_rel": 0.0, "grad_p99_rel": 0.0}
    for g, w in zip(gots, ref):
        e = errors(g.to(dev), w, scale=max(float(w.abs().max()),
                                           GRAD_NOISE * top))
        for key in worst:
            worst[key] = max(worst[key], e[key[5:]] if e["finite"]
                             else float("inf"))
    grad_limits = {k: STEP_LIMITS[k] for k in worst}
    broken = [k for k, lim in grad_limits.items() if not worst[k] <= lim]
    report["sharded"]["pipeline_grad"] = dict(worst, broken=broken,
                                              leaves=len(ref))
    if broken or len(gots) != len(ref):
        failures.append(f"pipeline (d) gradient breaks {broken}")
    print(f"pipeline (d) gradient through pipeline_apply (plain stage, "
          f"synthetic_qm9.yml f32, {PIPE_MICRO} x "
          f"{GRAD_PIPE_B // PIPE_MICRO} graphs) against the sequential "
          f"stack, {len(ref)} leaves: {json.dumps(worst)}, limits "
          f"{grad_limits}, broken {broken}; the world {world_s:.1f} s",
          flush=True)

    # (b) the ('dcn', 'dp') mesh: four ranks
    base = dict(train_cases["f32"])
    dcn_cases = {"dcn": base, "flat": base,
                 "fault cross_slice_skipped": dict(
                     base, fault="cross_slice_skipped")}
    t0 = time.time()
    dcn_out = launch(dcn_card_world, 4, dcn_cases, device="cuda:0",
                     backend="gloo")
    dcn_s = time.time() - t0
    dcn_rows = {
        "dcn_vs_single": step_errors(dcn_out[0]["dcn"]["step"], refs["f32"],
                                     lr),
        "dcn_vs_flat": step_errors(dcn_out[0]["dcn"]["step"],
                                   dcn_out[0]["flat"]["step"], lr),
        "fault cross_slice_skipped": step_errors(
            dcn_out[0]["fault cross_slice_skipped"]["step"], refs["f32"], lr)}
    report["sharded"]["dcn"] = dcn_rows
    print_step_rows("dcn (b) ('dcn', 'dp') = (2, 2) DP step over four gloo "
                    "ranks on card 0", dcn_rows, STEP_LIMITS, failures)
    dcn_timing = [dict(ms_per_step=r["dcn"]["ms_per_step"],
                       all_reduce_ms=r["dcn"]["all_reduce_ms"],
                       flat_ms_per_step=r["flat"]["ms_per_step"],
                       flat_all_reduce_ms=r["flat"]["all_reduce_ms"])
                  for r in dcn_out]
    report["sharded"]["dcn_timing"] = dcn_timing
    print(f"dcn (b) ms per rank (B=64 as 4 x 16, four ranks sharing card 0 "
          f"over gloo): {json.dumps(dcn_timing)}; the world {dcn_s:.1f} s "
          f"({card})", flush=True)
    return failures, launched


def _pp_view():
    """A 'pp' mesh of two stages seen from rank 0, without a world: what
    schnet_pipeline needs to stack the stages."""
    import torch

    from agdiff_torch.parallel.mesh import Mesh

    return Mesh(2, 0, torch.device("cpu"), "gloo", axis_names=("pp",),
                dims=(2,))


def pipe_plain_checks(fwd, stage, stacked, payload):
    """K3 against its plain version on the inputs the sequential K3 stack
    gives each of its blocks (microbatch 0), and the plain stack's h over
    every microbatch: ({block: errors row}, plain h)."""
    import torch

    from agdiff_torch.kernels import fused
    from agdiff_torch.models.fast_forward import (
        node_input,
        schnet_block,
        stacked_distance_weights,
    )
    from agdiff_torch.parallel import pipeline

    rows = {}
    h, e, el, env = (a[0] for a in payload)
    b, n = env.shape[:2]
    for s in range(PIPE_STAGES):
        blocks = pipeline.stage_slice(stacked, s)
        we = stacked_distance_weights(
            blocks, el.reshape(b, n * n, 1), env.reshape(b, n * n),
            fwd.sigmoid).reshape(-1, b, n, n)
        for k, blk in enumerate(blocks):
            c1, c2 = blk["convs"]
            args = (e, we[2 * k], we[2 * k + 1], node_input(c1, h),
                    node_input(c2, h), c1, c2)
            got = fused.interaction_block_aggregate(*args)
            ref = fused.interaction_block_aggregate_plain(*args)
            rows[f"stage {s} block {k}"] = {
                key: max(errors(g, r)[key] for g, r in zip(got, ref))
                for key in ("max_rel", "median_rel", "p99_rel",
                            "beyond_1pct")}
            h = schnet_block(blk, h, *got, fwd.softplus, fwd.sigmoid)
    real = pipeline.interaction_block_aggregate
    pipeline.interaction_block_aggregate = \
        fused.interaction_block_aggregate_plain
    try:
        plain = stage_sequence(stage, stacked, payload, PIPE_STAGES)
    finally:
        pipeline.interaction_block_aggregate = real
    torch.cuda.synchronize()
    return rows, plain


# ---- phase 15: spatial sharding and the protein path ------------------------

# (a) the sp step over two gloo ranks on card 0, a ('dp', 'sp') = (1, 2)
# mesh, against the single-process card step of the same layout: (name,
# label of its limits, packed_pairs, its (N, B) shapes) of
# synthetic_qm9.yml dense and packed (f32) and of qm9_fast.yml as written
# (bf16, packed) and dense; at N=32, B=8 (the training batch's first
# graphs), at N=256, B=2 (two of its molecules padded to 256) and, f32, at
# N=512, B=1 (how each layout's time and peak grow with N)
SP_LAYOUTS = (("f32", "f32", False, ((32, 8), (256, 2), (512, 1))),
              ("f32 packed", "f32", True, ((32, 8), (256, 2), (512, 1))),
              ("bf16", "bf16", False, ((256, 2),)),
              ("bf16 packed", "bf16", True, ((32, 8), (256, 2))))
SP_TIMED_STEPS = 3
# a rank's peak allocation above its baseline over SP_TIMED_STEPS steps, as
# a share of the single-process step's, at N=256: the pair tensors halve,
# and a share near 1 means an op gathered a whole (B, N, N) plane
SP_MEMORY_SHARE = 0.6
# the moments' worst leaf: f32 on STEP_LIMITS' per-leaf scale (nu = (1 -
# b2) g^2 doubles the gradient's relative error), bf16 over the moment's
# largest value, as BF16_STEP_LIMITS' grad_top_rel
SP_MOMENT_LIMITS = {"f32": 2 * STEP_LIMITS["grad_max_rel"],
                    "bf16": 2 * BF16_STEP_LIMITS["grad_top_rel"]}
# (b) the faults an sp step must not have (tests/torch_port_shard_ranks.py
# plants the same on the CPU), each at f32, N=32
SP_FAULTS = ("transposed_dropped", "own_row_stats", "own_rows_hj",
             "own_rows_count")
# and the packed step's (sp_packed_faults().SP_PACKED_FAULTS), on the f32
# packed case at N=32
# (c) the alanine dipeptide example on qm9_fast.yml's seeded weights
EXAMPLE_SAMPLES, EXAMPLE_STEPS, EXAMPLE_CLIP_LOCAL = 64, 50, 20.0
# (d) subgraph_position_scores over the dipeptide through 'pksf'
SUBGRAPH_MAX_NODES, SUBGRAPH_CUTOFF = 32, 3.0
# residue names of the dipeptide's atoms (ACE 1, ALA 2, NME 3), so that
# its PDB carries backbone annotations
DIPEPTIDE_NAMES = ("CH3", "H1", "H2", "H3", "C", "O", "N", "H", "CA", "HA",
                   "CB", "HB1", "HB2", "HB3", "C", "O", "N", "H", "CH3",
                   "H1", "H2", "H3")
DIPEPTIDE_RESIDUES = (("ACE", 6), ("ALA", 10), ("NME", 6))


@contextlib.contextmanager
def sp_fault(name):
    """A planted fault of the sp step: the transposed terms of the
    equivariant transform dropped; BatchNorm's statistics from the rank's
    own rows; the pair ops' j side from the rank's own rows (h not
    gathered); the loss's node count the rank's own; or one of the packed
    sp step's (sp_packed_faults())."""
    import torch

    from agdiff_torch.ops import masked
    from agdiff_torch.parallel.mesh import NodeLayout
    from agdiff_torch.train import train_step as ts

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "transposed_dropped":
        patch(NodeLayout, "columns", lambda self, partial: torch.zeros_like(
            partial[:, self.rows]))
    elif name == "own_row_stats":
        real_stats = masked.masked_batch_norm_stats
        patch(masked, "masked_batch_norm_stats",
              lambda x, mask, group=None: real_stats(x, mask))
    elif name == "own_rows_hj":
        real_gather = NodeLayout.gather

        def own_rows(self, x):
            if x.is_floating_point() and x.shape[-1] != 3:
                return torch.cat([x] * self.mesh.world_size, 1)
            return real_gather(self, x)
        patch(NodeLayout, "gather", own_rows)
    elif name == "own_rows_count":
        real_loss = ts.diffusion_loss
        patch(ts, "diffusion_loss",
              lambda *a: real_loss(*a[:5], None, *a[6:]))
    elif name in sp_packed_faults().SP_PACKED_FAULTS:
        sp_packed_faults().patch_packed(name, patch)
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def sp_packed_faults():
    """tests/torch_port_sp_faults.py, which plants the packed sp step's
    faults for the CPU tests and for this script."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_sp_faults

    return torch_port_sp_faults


def sp_moments(state) -> dict:
    """{parameter name: (mu, nu)} of both Adams, on the CPU."""
    names = {id(p): n for n, p in state.module.named_parameters()}
    return {names[id(p)]: (mu.detach().cpu().clone(),
                           nu.detach().cpu().clone())
            for adam in state.optimizer.adams.values()
            for p, mu, nu in zip(adam.params, adam.mu, adam.nu)}


def sp_run(step, state, batch, case, dev) -> dict:
    """One step on the case's t and noise (a planted fault when the case
    names one): step_result's tuple and the moments; a sound step is then
    timed over SP_TIMED_STEPS steps, with the peak allocation above the
    baseline before them."""
    import copy

    import torch

    module = state.module
    before = {n: p.detach().cpu().clone()
              for n, p in module.named_parameters()}
    with sp_fault(case.get("fault")):
        metrics = step(state, batch, case["t"].to(dev),
                       case["noise"].to(dev))
    out = {"step": copy.deepcopy(step_result(metrics, module, before)),
           "moments": sp_moments(state)}
    if case.get("fault") is None:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        for _ in range(SP_TIMED_STEPS):
            step(state, batch)
        torch.cuda.synchronize(dev)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
            / SP_TIMED_STEPS
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    return out


def sp_state(case, dev):
    import torch

    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState

    config = case["config"]
    module = DualEncoderEpsNetwork(config.model)
    module.load_state_dict(case["init"])
    module = module.to(dev)
    return TrainState(step=0, module=module,
                      optimizer=make_optimizer(module, config.train),
                      generator=torch.Generator(device=dev).manual_seed(0))


def sp_rank(group, case) -> dict:
    """(a)-(b) one sp step of the case on the world's ('dp', 'sp') =
    (1, 2) mesh, this rank's node rows of the batch (sp_run), and the
    pairs it owns under packed_pairs (0 dense)."""
    from agdiff_torch.ops.pairs import owned_pairs
    from agdiff_torch.parallel import sharded
    from agdiff_torch.parallel.mesh import NodeLayout, make_hybrid_mesh

    mesh = make_hybrid_mesh(2, 2, model_axis="sp")
    state = sp_state(case, group.device)
    step = sharded.make_sharded_train_step(case["config"], mesh, state,
                                           "sp")
    shard = sharded.shard_graph_batch_nodes(case["batch"], mesh)
    out = sp_run(step, state, shard, case, group.device)
    out["rows"] = tuple(shard.pos.shape[:2])
    out["pairs"] = (owned_pairs(NodeLayout(mesh.axis("sp"),
                                           shard.pos.shape[1]),
                                "cpu").num_pairs
                    if case["config"].model.packed_pairs else 0)
    return out


def sp_card_world(group, cases) -> list:
    """Phase 15 (a)-(b) in each of two gloo ranks on card 0."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {name: sp_rank(group, case) for name, case in cases.items()}
    return dp_every_rank(group, out)


def padded_nodes(x, n, axes):
    """x with zeros appended on `axes` up to n entries each."""
    import torch.nn.functional as F

    pad = [0] * (2 * x.dim())
    for a in axes:
        pad[2 * (x.dim() - 1 - a) + 1] = n - x.shape[a]
    return F.pad(x, pad)


def sp_cases(train_cases) -> dict:
    """(a)'s and (b)'s cases: {name: case}, the first B graphs of each
    config's training batch, padded with empty node slots to N, with
    their t and noise (zero on the new slots)."""
    cases = {}
    for prefix, label, packed, shapes in SP_LAYOUTS:
        base = train_cases[label]
        config = base["config"]
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, packed_pairs=packed))
        for n, b in shapes:
            batch = base["batch"]
            batch = batch.replace(
                atom_type=padded_nodes(batch.atom_type[:b], n, (1,)),
                pos=padded_nodes(batch.pos[:b], n, (1,)),
                node_mask=padded_nodes(batch.node_mask[:b], n, (1,)),
                bond_adj=padded_nodes(batch.bond_adj[:b], n, (1, 2)),
                graph_mask=batch.graph_mask[:b])
            cases[f"{prefix} N={n} B={b}"] = dict(
                label=label, config=config, init=base["init"], batch=batch,
                t=base["t"][:b], noise=padded_nodes(base["noise"][:b], n,
                                                    (1,)))
    for fault in SP_FAULTS:
        cases[f"f32 fault {fault}"] = dict(cases["f32 N=32 B=8"],
                                           fault=fault)
    for fault in sp_packed_faults().SP_PACKED_FAULTS:
        cases[f"f32 packed fault {fault}"] = dict(
            cases["f32 packed N=32 B=8"], fault=fault)
    return cases


def moment_error(got, ref, label) -> tuple:
    """The worst moment leaf of an sp step against the single step's:
    (error, 'mu|nu name'); f32 on each leaf's scale (GRAD_NOISE of the
    moment's largest at least), bf16 over the moment's largest value."""
    worst = (0.0, "")
    for k, part in enumerate(("mu", "nu")):
        top = max(float(m[k].abs().max()) for m in ref.values())
        for name, m in ref.items():
            d = float((got[name][k] - m[k]).abs().max())
            scale = top if label == "bf16" else max(
                float(m[k].abs().max()), GRAD_NOISE * top)
            e = d / scale if d == d else float("inf")
            if e >= worst[0]:
                worst = (e, f"{part} {name}")
    return worst


def sp_row(got, ref, label, lr) -> dict:
    """One sp case (rank 0) against the single-process step: the f32 or
    bf16 step row, the gradient norm (f32) and the moments' worst leaf,
    with the limits it breaks."""
    if label == "f32":
        row = step_errors(got["step"], ref["step"], lr)
        want = ref["step"][0]["grad_norm"]
        row["grad_norm_rel"] = abs(got["step"][0]["grad_norm"] - want) / want
        limits = SHARD_LIMITS
    else:
        row = bf16_step_errors(got["step"], ref["step"])
        limits = BF16_STEP_LIMITS
    row["moment_rel"], row["moment_leaf"] = moment_error(
        got["moments"], ref["moments"], label)
    row["broken"] = [k for k, lim in limits.items() if not row[k] <= lim]
    if not row["moment_rel"] <= SP_MOMENT_LIMITS[label]:
        row["broken"].append("moment_rel")
    return row


def dipeptide_structure():
    """The example's dipeptide written as a PDB with residue names and
    parsed back: (Molecule, annotations)."""
    import tempfile

    import numpy as np

    from agdiff_torch.chem.pdb import parse_pdb, write_pdb
    from agdiff_torch.examples.alanine_dipeptide import (
        build_alanine_dipeptide,
    )

    mol = build_alanine_dipeptide()
    ann = {"atom_name": np.array(DIPEPTIDE_NAMES),
           "res_name": np.array([r for r, k in DIPEPTIDE_RESIDUES
                                 for _ in range(k)]),
           "res_id": np.array([i + 1 for i, (_, k) in enumerate(
               DIPEPTIDE_RESIDUES) for _ in range(k)], np.int32)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dipeptide.pdb")
        write_pdb(path, mol, mol.pos, ann)
        with open(path) as f:
            return parse_pdb(f.read())


def position_scores(out, pos):
    """The global (off the bond graph) and local position scores of a
    model output at pos, unclipped."""
    from agdiff_torch.ops.geometry import eq_transform_dense

    local = out.local_mask.float()
    return (eq_transform_dense(out.edge_inv_global * (1.0 - local), pos,
                               out.edge_mask, out.edge_length)
            + eq_transform_dense(out.edge_inv_local, pos, out.local_mask,
                                 out.edge_length))


def run_example(qcfg, dev, report) -> tuple:
    """(c) python -m agdiff_torch.examples.alanine_dipeptide (runpy, as
    -m runs it) on a reference .pt of qm9_fast.yml's seeded weights:
    EXAMPLE_SAMPLES samples of EXAMPLE_STEPS steps at --clip_local
    EXAMPLE_CLIP_LOCAL; samples.pdb must parse back to as many models
    and every sample be finite. Returns (failures, K1 launches)."""
    import runpy

    import numpy as np
    import torch

    from agdiff_torch.chem.pdb import parse_pdb
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.reference_checkpoint import (
        export_reference_state_dict,
    )
    from agdiff_torch.models.weights import init_random

    out_dir = os.path.join(OUT_DIR, "alanine")
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "model.pt")
    torch.save({"model": export_reference_state_dict(init_random(
        DualEncoderEpsNetwork(qcfg), SEED)),
        "config": {"model": dataclasses.asdict(qcfg)}}, ckpt)
    argv = sys.argv
    sys.argv = ["alanine_dipeptide", ckpt, "--num_samples",
                str(EXAMPLE_SAMPLES), "--n_steps", str(EXAMPLE_STEPS),
                "--clip_local", str(EXAMPLE_CLIP_LOCAL), "--out", out_dir]
    zero_counts()
    t0 = time.time()
    try:
        runpy.run_module("agdiff_torch.examples.alanine_dipeptide",
                         run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv
    torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    launches = launch_counts()
    k1 = launches.get("stack_packed/stack_full:triu", 0)
    with open(os.path.join(out_dir, "samples.pdb")) as f:
        text = f.read()
    models = sum(line.startswith("MODEL ") for line in text.splitlines())
    atoms = parse_pdb(text)[0].num_nodes
    saved = np.load(os.path.join(out_dir, "samples.npz"))
    pos, rmsd = saved["pos_gen"], saved["rmsd"]
    row = dict(models=models, atoms=atoms, k1_launches=k1,
               other_launches={k: v for k, v in launches.items()
                               if k != "stack_packed/stack_full:triu"},
               finite=bool(np.isfinite(pos).all()),
               rmsd_mean=float(rmsd.mean()), rmsd_min=float(rmsd.min()),
               rmsd_max=float(rmsd.max()), seconds=seconds)
    report["spatial"]["example"] = row
    failures = []
    if models != EXAMPLE_SAMPLES or atoms != EXAMPLE_SAMPLES * 22:
        failures.append(f"example (c): samples.pdb holds {models} models "
                        f"and {atoms} atoms")
    if pos.shape != (EXAMPLE_SAMPLES, 22, 3) or not row["finite"]:
        failures.append(f"example (c): samples {pos.shape}, finite "
                        f"{row['finite']}")
    if not k1:
        failures.append(f"example (c): no K1 launch ({launches})")
    print(f"protein (c) python -m agdiff_torch.examples.alanine_dipeptide, "
          f"qm9_fast.yml seeded weights ('pksf', bucket 32, chunk 50), "
          f"{EXAMPLE_SAMPLES} samples x {EXAMPLE_STEPS} steps, clip_local "
          f"{EXAMPLE_CLIP_LOCAL}: {json.dumps(row)}", flush=True)
    return failures, k1


def run_subgraph_scores(qcfg, qmodel, dev, report) -> tuple:
    """(d) subgraph_position_scores over the dipeptide (max_nodes
    SUBGRAPH_MAX_NODES, cutoff SUBGRAPH_CUTOFF A) with a 'pksf' score
    function, against the same function on K1's plain twin: each
    subgraph's score planes at K1's triu limits (QM9_LIMITS), the
    averaged scores within K1_LIMITS' max_rel. Returns (failures, K1
    launches)."""
    import torch

    from agdiff_torch.data.protein import subgraph_position_scores
    from agdiff_torch.models.fast_forward import build_fast_forward

    mol, ann = dipeptide_structure()
    fwd = build_fast_forward(qcfg, qmodel, "pksf")

    def score_fn(planes):
        def score(batch):
            batch = batch.to(dev)
            with torch.no_grad():
                out = fwd(batch)
            planes.append((out.edge_inv_global, out.edge_inv_local))
            return position_scores(out, batch.pos)
        return score

    zero_counts()
    kernel_planes, plain_planes = [], []
    got = subgraph_position_scores(mol, ann, score_fn(kernel_planes),
                                   SUBGRAPH_MAX_NODES, SUBGRAPH_CUTOFF,
                                   qcfg.edge_order)
    torch.cuda.synchronize(dev)
    launches = launch_counts()
    k1 = launches.get("stack_packed/stack_full:triu", 0)
    with plain_twins():
        want = subgraph_position_scores(mol, ann, score_fn(plain_planes),
                                        SUBGRAPH_MAX_NODES, SUBGRAPH_CUTOFF,
                                        qcfg.edge_order)
    failures, planes = [], []
    for g, w in zip(kernel_planes, plain_planes, strict=True):
        rows = {name: errors(a, b) for name, a, b in zip(
            ("global", "local"), g, w)}
        planes.append(rows)
        broken = broken_limits(rows, QM9_LIMITS)
        if broken:
            failures.append(f"protein (d): subgraph {len(planes) - 1}'s "
                            f"planes break {broken}")
    scores = errors(torch.from_numpy(got), torch.from_numpy(want))
    row = dict(subgraphs=len(kernel_planes), k1_launches=k1,
               other_launches={k: v for k, v in launches.items()
                               if k != "stack_packed/stack_full:triu"},
               planes=planes, scores=scores)
    report["spatial"]["subgraph_scores"] = row
    if len(kernel_planes) < 2 or k1 != len(kernel_planes):
        failures.append(f"protein (d): {len(kernel_planes)} subgraphs, "
                        f"{k1} K1 launches")
    if not (scores["finite"] and scores["max_rel"]
            <= K1_LIMITS["max_rel"]):
        failures.append(f"protein (d): scores against the plain twin "
                        f"{scores}")
    shown = [{name: (r["max_rel"], r["median_rel"]) for name, r in p.items()}
             for p in planes]
    print(f"protein (d) subgraph_position_scores over the dipeptide "
          f"(max_nodes {SUBGRAPH_MAX_NODES}, cutoff {SUBGRAPH_CUTOFF} A) "
          f"through 'pksf' against K1's plain twin: {len(kernel_planes)} "
          f"subgraphs, K1 launches {k1}; planes (max_rel, median_rel) "
          f"{shown}; scores max_rel {scores['max_rel']:.3e} median_rel "
          f"{scores['median_rel']:.3e}", flush=True)
    return failures, k1


def run_spatial(qcfg, qmodel, train_cases, dev, report):
    """Phase 15: (a) the sp train step on two gloo ranks on card 0 against
    the single-process card step (SP_LAYOUTS), f32 and bf16, with
    each rank's peak allocation as a share of the single step's; (b)
    planted faults; (c) the alanine dipeptide example; (d)
    subgraph-decomposed scores through K1. Returns (failures, K1
    launches of (c) and (d))."""
    from agdiff_torch.parallel import launch
    from agdiff_torch.train.train_step import make_train_step

    report["spatial"] = {}
    card = report["card"]
    cases = sp_cases(train_cases)
    t0 = time.time()
    ranks_out = launch(sp_card_world, 2, cases, device="cuda:0",
                       backend="gloo")
    world_s = time.time() - t0
    refs = {name: sp_run(make_train_step(case["config"], dev),
                         sp_state(case, dev), case["batch"].to(dev), case,
                         dev)
            for name, case in cases.items() if "fault" not in name}
    lr = train_cases["f32"]["config"].train.optimizer.lr
    failures, rows, memory = [], {}, {}
    for name, case in cases.items():
        ref = refs[name.split(" fault")[0] + " N=32 B=8"
                   if "fault" in name else name]
        rows[name] = sp_row(ranks_out[0][name], ref, case["label"], lr)
        if "fault" in name:
            if not rows[name]["broken"]:
                failures.append(f"sp (b) {name}: breaks no limit")
            continue
        if rows[name]["broken"]:
            failures.append(f"sp (a) {name}: breaks {rows[name]['broken']}")
        same = all(torch_equal_params(r[name], ranks_out[0][name])
                   for r in ranks_out)
        shares = [r[name]["peak_bytes"] / ref["peak_bytes"]
                  for r in ranks_out]
        memory[name] = dict(
            rank_peak_mib=[r[name]["peak_bytes"] / 2 ** 20
                           for r in ranks_out],
            single_peak_mib=ref["peak_bytes"] / 2 ** 20, share=shares,
            rank_ms_per_step=[r[name]["ms_per_step"] for r in ranks_out],
            single_ms_per_step=ref["ms_per_step"],
            rows=[r[name]["rows"] for r in ranks_out],
            pairs=[r[name]["pairs"] for r in ranks_out], replicas_equal=same)
        if not same:
            failures.append(f"sp (a) {name}: the ranks' parameters differ")
        n = case["batch"].pos.shape[1]
        if case["config"].model.packed_pairs and (
                sum(memory[name]["pairs"]) != n * (n - 1) // 2
                or max(memory[name]["pairs"]) - min(memory[name]["pairs"])
                > n):
            failures.append(f"sp (a) {name}: owned pairs "
                            f"{memory[name]['pairs']} do not split the "
                            f"triangle evenly")
        if case["batch"].pos.shape[1] == 256 and not all(
                s <= SP_MEMORY_SHARE for s in shares):
            failures.append(f"sp (a) {name}: a rank's peak is {shares} of "
                            f"the single step's (at most {SP_MEMORY_SHARE})")
    report["spatial"]["steps"] = rows
    report["spatial"]["memory"] = memory
    for label, limits in (("f32", SHARD_LIMITS), ("bf16", BF16_STEP_LIMITS)):
        print_step_rows(
            f"sp (a)-(b) {label} train step on a ('dp', 'sp') = (1, 2) mesh "
            f"of two gloo ranks on card 0 against the single-process card "
            f"step (moments' worst leaf within "
            f"{SP_MOMENT_LIMITS[label]})",
            {k.split(" ", 1)[1]: v for k, v in rows.items()
             if k.split()[0] == label}, limits, [])
    print(f"sp (a) per rank: peak allocation above the pre-step baseline "
          f"as a share of the single step's (at N=256 at most "
          f"{SP_MEMORY_SHARE}), ms per step (two ranks sharing card 0 over "
          f"gloo, not a scaling figure): {json.dumps(memory)}; the world "
          f"{world_s:.1f} s ({card})", flush=True)
    failed, k1_example = run_example(qcfg, dev, report)
    failures += failed
    failed, k1_scores = run_subgraph_scores(qcfg, qmodel, dev, report)
    failures += failed
    return failures, k1_example + k1_scores


# ---- phase 16: the host modules and the RDKit seam -------------------------

# (a) the native relaxation against the numpy body: each call's positions
# within the JAX package's tolerance (tests/test_native_relax.py)
RELAX_TOL = 1e-6
# (b) the profiled graphed 'pksf' ladder
PROFILED_STEPS = 5
# (c) the synthetic end-to-end example's training iterations: the fewest of
# those tried at which its assertion held in three runs on the card (PERF.md
# section 6; 1000 held too and took 90 s of the phase)
E2E_ITERS = 200
# (d) the SMILES generation's ladder; its bf16 checkpoint's iterations
SMILES_STEPS = 50
SMILES_TRAIN_ITERS = 2


def check_native_relax(report) -> list:
    """(a) Each _relax call of synthetic_dataset(2, seed=7, chem='rich',
    min_heavy=20, max_heavy=28), replayed through the native kernel and
    the numpy body, within RELAX_TOL; two native generations bit-equal;
    ms per molecule of each path's relaxation calls and of the whole
    generation."""
    import numpy as np

    from agdiff_torch.data import native_relax, synthetic

    t0 = time.perf_counter()
    native_relax.get_lib()
    build_s = time.perf_counter() - t0
    kw = dict(seed=7, chem="rich", min_heavy=20, max_heavy=28)
    real, calls = synthetic._relax, []

    def record(*args, **kwargs):
        calls.append(([np.array(a) if isinstance(a, np.ndarray) else a
                       for a in args], kwargs))
        return real(*args, **kwargs)

    synthetic._relax = record
    try:
        first = synthetic.synthetic_dataset(2, **kw)
    finally:
        synthetic._relax = real
    t0 = time.perf_counter()
    second = synthetic.synthetic_dataset(2, **kw)
    native_s = time.perf_counter() - t0
    synthetic._relax = lambda *a, **k: real(*a, **{**k, "use_native": False})
    try:
        t0 = time.perf_counter()
        plain = synthetic.synthetic_dataset(2, **kw)
        numpy_s = time.perf_counter() - t0
    finally:
        synthetic._relax = real
    worst, times = 0.0, {True: 0.0, False: 0.0}
    for args, kwargs in calls:
        outs = {}
        for native in (True, False):
            copies = [np.array(a) if isinstance(a, np.ndarray) else a
                      for a in args]
            t0 = time.perf_counter()
            outs[native] = real(*copies, **{**kwargs, "use_native": native})
            times[native] += time.perf_counter() - t0
        worst = max(worst, float(np.abs(outs[True] - outs[False]).max()))
    equal = all(np.array_equal(getattr(a, f), getattr(b, f))
                for a, b in zip(first, second)
                for f in ("atom_type", "pos", "bond_index", "bond_type"))
    same_shapes = [a.pos.shape == b.pos.shape for a, b in zip(second, plain)]
    row = dict(
        atoms=[m.num_nodes for m in second], relax_calls=len(calls),
        worst_abs_diff=worst, native_runs_equal=equal, build_s=build_s,
        relax_ms_per_mol_native=times[True] / len(second) * 1e3,
        relax_ms_per_mol_numpy=times[False] / len(second) * 1e3,
        generation_ms_per_mol_native=native_s / len(second) * 1e3,
        generation_ms_per_mol_numpy=numpy_s / len(second) * 1e3,
        dataset_max_abs_diff=max(
            float(np.abs(a.pos - b.pos).max()) if same else float("inf")
            for a, b, same in zip(second, plain, same_shapes)))
    report["host"]["native_relax"] = row
    failures = []
    if not calls or worst > RELAX_TOL:
        failures.append(f"host (a): {len(calls)} relax calls, native "
                        f"against numpy {worst:.3e} (at most {RELAX_TOL})")
    if not equal:
        failures.append("host (a): two native generations differ")
    print(f"host (a) native relax (g++ on this machine, built in "
          f"{build_s:.2f} s) on synthetic_dataset(2, seed=7, chem='rich', "
          f"min_heavy=20, max_heavy=28), {row['atoms']} atoms: "
          f"{len(calls)} calls, native against numpy at most {worst:.3e}; "
          f"two native runs bit-equal {equal}; relaxation ms per molecule "
          f"native {row['relax_ms_per_mol_native']:.3f}, numpy "
          f"{row['relax_ms_per_mol_numpy']:.3f}; whole generation ms per "
          f"molecule native {row['generation_ms_per_mol_native']:.3f}, "
          f"numpy {row['generation_ms_per_mol_numpy']:.3f} (host CPU)",
          flush=True)
    return failures


def check_profiling(qcfg, qmodel, qmols, dev, report) -> tuple:
    """(b) utils/profiling.py around PROFILED_STEPS steps of the graphed
    'pksf' ladder at QM9 B=128 N=32 (captured by a first run outside the
    window). Returns (failures, K1 launches of the traced run)."""
    import glob
    import shutil
    import tempfile

    import torch

    from agdiff_torch.data.bucketing import pad_molecules
    from agdiff_torch.models.fast_forward import build_fast_forward
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import (
        SamplerConfig,
        build_fast_sampler,
    )
    from agdiff_torch.utils.profiling import (
        Timer,
        device_memory_stats,
        trace,
    )

    sampler = build_fast_sampler(
        build_fast_forward(qcfg, qmodel, "pksf"), make_diffusion(qcfg),
        SamplerConfig(n_steps=PROFILED_STEPS, w_global=0.3), graph=True)
    batch = pad_molecules([qmols[0]] * CHUNK, 32, batch_size=CHUNK,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pos0 = torch.randn(batch.pos.shape, generator=gen, device=dev)
    sampler(batch, pos0, generator=gen)
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix="trace-")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counts()
    try:
        with trace(log_dir):
            with Timer() as timer:
                start.record()
                result = sampler(batch, pos0, generator=gen)
                end.record()
                timer.block_on(result)
        torch.cuda.synchronize()
        k1 = launch_counts().get("stack_packed/stack_full:triu", 0)
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        text = ""
        for path in files:
            with open(path) as f:
                text += f.read()
        kernel_events = text.count("stack_kernel")
        trace_bytes = len(text)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    event_ms = start.elapsed_time(end)
    stats = device_memory_stats()
    row = dict(steps=PROFILED_STEPS, batch=CHUNK, bucket=32,
               trace_files=len(files), trace_bytes=trace_bytes,
               k1_names_in_trace=kernel_events, timer_ms=timer.elapsed * 1e3,
               event_ms=event_ms, k1_launches=k1, memory=stats)
    report["host"]["profiling"] = row
    failures = []
    if len(files) != 1 or not kernel_events:
        failures.append(f"host (b): {len(files)} trace files, K1's kernel "
                        f"named {kernel_events} times")
    if not timer.elapsed * 1e3 >= event_ms:
        failures.append(f"host (b): Timer {timer.elapsed * 1e3:.3f} ms below "
                        f"the events' {event_ms:.3f} ms")
    if not (stats and stats["bytes_in_use"] > 0
            and stats["peak_bytes_in_use"] >= stats["bytes_in_use"]):
        failures.append(f"host (b): device_memory_stats() {stats}")
    if not k1:
        failures.append("host (b): the traced ladder launched no K1")
    print(f"host (b) utils/profiling.py around {PROFILED_STEPS} graphed "
          f"'pksf' steps at B={CHUNK} N=32: trace {len(files)} file(s), "
          f"{trace_bytes} bytes, K1's kernel named {kernel_events} times; "
          f"Timer {timer.elapsed * 1e3:.3f} ms, CUDA events "
          f"{event_ms:.3f} ms; K1 launches {k1}; memory {stats} "
          f"({report['card']})", flush=True)
    return failures, k1


def run_e2e_example(dev, report) -> list:
    """(c) The synthetic end-to-end example at E2E_ITERS iterations on
    the card; its own assertion (trained MAT-R below untrained) must
    hold."""
    from agdiff_torch.examples import synthetic_end_to_end

    out = os.path.join(OUT_DIR, "e2e")
    t0 = time.time()
    try:
        res = synthetic_end_to_end.main(["--iters", str(E2E_ITERS), "--out",
                                         out, "--device", str(dev)])
    except AssertionError as err:
        report["host"]["e2e"] = dict(iters=E2E_ITERS, failed=str(err))
        return [f"host (c): the example's assertion failed: {err}"]
    res.update(iters=E2E_ITERS, seconds=time.time() - t0)
    report["host"]["e2e"] = res
    print(f"host (c) synthetic_end_to_end --iters {E2E_ITERS}: MAT-R "
          f"{res['mat_untrained']:.4f} -> {res['mat_trained']:.4f} A, "
          f"COV-R@1A {res['cov_untrained']:.4f} -> {res['cov_trained']:.4f}; "
          f"training {res['train_s']:.1f} s "
          f"({E2E_ITERS / res['train_s']:.1f} it/s), all "
          f"{res['seconds']:.1f} s ({report['card']})", flush=True)
    return []


def run_smiles_generation(qmols, dev, report) -> tuple:
    """(d) generate_for_molecule on qm9_synthetic.json's first molecule
    from a bf16 checkpoint of SMILES_TRAIN_ITERS iterations of
    cli/train.py on qm9_fast.yml, --fast ('pksf'), SMILES_STEPS steps,
    --num_samples auto. Returns (failures, K1 launches)."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from agdiff_torch.cli import smiles_generation
    from agdiff_torch.cli import train as train_cli

    root = os.path.join(OUT_DIR, "smiles")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(ROOT, "configs", FAST_CONFIG)) as f:
        raw = yaml.safe_load(f)
    raw["train"].update(max_iters=SMILES_TRAIN_ITERS,
                        val_freq=SMILES_TRAIN_ITERS)
    cfg_path = os.path.join(root, "qm9_fast.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    run = train_cli.main([cfg_path, "--logdir", os.path.join(root, "train"),
                          "--synthetic", "64", "--device", str(dev)])
    mol = qmols[0]
    args = smiles_generation.parse_args([
        run.log_dir, "--smiles", mol.smiles, "--out_sdf",
        os.path.join(root, "unused.sdf"), "--fast", "--n_steps",
        str(SMILES_STEPS)])
    zero_counts()
    t0 = time.time()
    pos = smiles_generation.generate_for_molecule(run.log_dir, mol, "auto",
                                                  args, dev)
    torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    launches = launch_counts()
    k1 = launches.get("stack_packed/stack_full:triu", 0)
    shutil.rmtree(os.path.join(run.log_dir, "checkpoints"))
    want = 5 * (1100 // mol.num_nodes)
    row = dict(atoms=mol.num_nodes, samples=int(pos.shape[0]),
               expected=want, finite=bool(np.isfinite(pos).all()),
               k1_launches=k1, other_launches={
                   k: v for k, v in launches.items()
                   if k != "stack_packed/stack_full:triu"},
               seconds=seconds, dtype=run.config.model.dtype)
    report["host"]["smiles_generation"] = row
    failures = []
    if pos.shape != (want, mol.num_nodes, 3) or not row["finite"]:
        failures.append(f"host (d): samples {pos.shape} (want {want}), "
                        f"finite {row['finite']}")
    if not k1:
        failures.append(f"host (d): no K1 launch ({launches})")
    print(f"host (d) smiles_generation.generate_for_molecule ({row['dtype']} "
          f"checkpoint of {SMILES_TRAIN_ITERS} cli/train.py iterations, "
          f"--fast, {SMILES_STEPS} steps, auto): {mol.num_nodes} atoms -> "
          f"{row['samples']} samples (5 x (1100 // {mol.num_nodes}) = "
          f"{want}), finite {row['finite']}, K1 launches {k1}, "
          f"{seconds:.1f} s", flush=True)
    return failures, k1


def check_refusals(report) -> list:
    """(e) Without RDKit or psikit installed, each entry point raises
    ImportError naming what is missing, and returns nothing."""
    import importlib.util
    import tempfile

    from agdiff_torch.chem import rdkit_bridge
    from agdiff_torch.cli import preprocess
    from agdiff_torch.eval.covmat import CovMatEvaluator
    from agdiff_torch.eval.properties import PropertyCalculator

    base = tempfile.mkdtemp(prefix="geom-")
    cases = (
        ("CovMatEvaluator(use_force_field=True)", "rdkit", "RDKit",
         lambda: CovMatEvaluator(use_force_field=True)),
        ("smiles_to_molecule", "rdkit", "RDKit",
         lambda: rdkit_bridge.smiles_to_molecule("CCO")),
        ("PropertyCalculator()", "psikit", "psikit",
         lambda: PropertyCalculator()),
        ("cli.preprocess geom", "rdkit", "RDKit",
         lambda: preprocess.main(["geom", "--base_path", base, "--dataset",
                                  "qm9", "--out_dir",
                                  os.path.join(base, "out")])))
    failures, rows = [], {}
    for label, package, named, call in cases:
        if importlib.util.find_spec(package) is not None:
            rows[label] = f"{package} is installed: not checked"
            continue
        try:
            got = call()
        except ImportError as err:
            rows[label] = str(err)
            if named not in str(err):
                failures.append(f"host (e) {label}: {err} names no {named}")
        else:
            rows[label] = f"returned {got!r}"
            failures.append(f"host (e) {label}: returned {got!r} without "
                            f"{package}")
    report["host"]["refusals"] = rows
    print(f"host (e) refusals: {json.dumps(rows)}", flush=True)
    return failures


def run_host(qcfg, qmodel, qmols, dev, report) -> tuple:
    """Phase 16: (a)-(e) of the module docstring. Returns (failures, K1
    launches of (b) and (d))."""
    report["host"] = {"part_s": {}}
    mark = [time.time()]

    def part(name):
        now = time.time()
        report["host"]["part_s"][name] = now - mark[0]
        mark[0] = now

    failures = check_native_relax(report)
    part("a native relax")
    failed, k1_profiled = check_profiling(qcfg, qmodel, qmols, dev, report)
    failures += failed
    part("b profiling")
    failures += run_e2e_example(dev, report)
    part("c example")
    failed, k1_smiles = run_smiles_generation(qmols, dev, report)
    failures += failed
    part("d smiles generation")
    failures += check_refusals(report)
    part("e refusals")
    print("phase 16 parts (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["host"]["part_s"].items()),
        flush=True)
    return failures, k1_profiled + k1_smiles


# ---- phase 17: a checkpoint of the JAX package in the port ------------------

JAX_FIXTURE = os.path.join(ROOT, "agdiff_torch", "data", "fixtures",
                           "jax_checkpoint_small")
# the eval forward against JAX's stored planes, on the working graph:
# |diff| <= FORWARD_ATOL + FORWARD_RTOL |ref| (the module path's class)
JAX_FORWARD_ATOL, JAX_FORWARD_RTOL = 2e-4, 2e-4
JAX_NORM_RTOL = SHARD_LIMITS["grad_norm_rel"]
JAX_RESUME_ITERS = 20   # cli/train.py iterations after the checkpoint's
JAX_GEN_MOLS = 4        # cli/generate.py --synthetic, QM9-size
JAX_GEN_STEPS = 50
# the reader's faults: the two Adams' states (count, lr, moments by
# partition) swapped where they can be (count and lr: the partitions hold
# different leaves); the running statistics left at their init (0, 1); the
# EMA shadow left at the parameters
JAX_FAULTS = ("adams_swapped", "batch_stats_dropped", "ema_at_params")


@contextlib.contextmanager
def jax_fault(name):
    """A planted fault in train/checkpoint.py's reader of converted JAX
    checkpoints (JAX_FAULTS)."""
    from agdiff_torch.train import checkpoint

    real = checkpoint.load_converted

    def faulty(path, config):
        payload = real(path, config)
        adams = payload["optimizer"]["adams"]
        if name == "adams_swapped":
            for key in ("count", "lr"):
                adams["global"][key], adams["local"][key] = \
                    adams["local"][key], adams["global"][key]
        elif name == "batch_stats_dropped":
            for key, t in payload["module"].items():
                if key.endswith("running_mean"):
                    t.zero_()
                elif key.endswith("running_var"):
                    t.fill_(1.0)
        elif name == "ema_at_params":
            payload["ema"] = {n: t.clone() for n, t in
                              payload["module"].items() if n in
                              payload["ema"]}
        return payload

    if name is not None:
        checkpoint.load_converted = faulty
    try:
        yield
    finally:
        checkpoint.load_converted = real


def jax_numbers() -> dict:
    """JAX's numbers stored beside the fixture (its reference/ folder)."""
    import numpy as np

    with np.load(os.path.join(JAX_FIXTURE, "reference",
                              "jax_numbers.npz")) as z:
        return {k: z[k] for k in z.files}


def jax_resumed(path, dev, fault=None):
    """The converted checkpoint `path` resumed on `dev` as Trainer.resume
    resumes one, the optimizer's learning rates those it restored: (state,
    payload)."""
    from agdiff_torch.train.checkpoint import load_checkpoint
    from agdiff_torch.train.train_step import create_train_state
    from agdiff_torch.train.trainer import restore_state

    with jax_fault(fault):
        ckpt = load_checkpoint(path, map_location=dev)
    state = create_train_state(ckpt["config"], dev)
    restore_state(state, ckpt)
    return state, ckpt


def jax_checkpoint_row(path, ref, dev, fault=None) -> dict:
    """The resumed fixture on the card against JAX's numbers: the eval
    forward, one step with the stored t and noise (step_errors against
    JAX's losses, gradient leaves and the stored parameter leaves), the
    gradient norm, the stored EMA leaves, and the restored learning
    rates against the plateau states; with the limits it breaks."""
    import torch

    from agdiff_torch.data.graph_batch import GraphBatch
    from agdiff_torch.models.weights import flax_leaf
    from agdiff_torch.train.train_step import make_train_step

    state, ckpt = jax_resumed(path, dev, fault)
    config, module = ckpt["config"], state.module
    batch = GraphBatch(**{f: torch.from_numpy(ref[f"batch/{f}"]).to(dev)
                          for f in ("atom_type", "pos", "node_mask",
                                    "bond_adj", "graph_mask")})
    names = {"/".join(flax_leaf(module, n)[1]): n
             for n, _ in module.named_parameters()}

    def port(key):
        """A stored flax leaf in the port's layout, on the CPU."""
        x = torch.from_numpy(ref[key])
        return x.T.contiguous() if key.endswith("kernel") else x

    lrs = state.optimizer.get_learning_rates()
    want_lrs = (ckpt["plateau_global"].lr, ckpt["plateau_local"].lr)
    lr_off = max(abs(a - b) / b for a, b in zip(lrs, want_lrs))
    with torch.no_grad():
        out = module(batch)
    mask = torch.from_numpy(ref["forward/edge_mask"]).to(dev)
    excess = 0.0
    for plane in ("edge_inv_global", "edge_inv_local"):
        want = torch.from_numpy(ref[f"forward/{plane}"]).to(dev)[mask]
        d = (getattr(out, plane)[mask] - want).abs()
        excess = max(excess, float((d / (JAX_FORWARD_ATOL + JAX_FORWARD_RTOL
                                         * want.abs())).max()))
    stored = [k[len("step/params/"):] for k in ref
              if k.startswith("step/params/")]
    params = dict(module.named_parameters())
    before = {names[k]: params[names[k]].detach().cpu().clone()
              for k in stored}
    metrics = make_train_step(config, dev)(
        state, batch, torch.from_numpy(ref["step/t"]).to(dev),
        torch.from_numpy(ref["step/noise"]).to(dev))
    got = step_result(metrics, module, before)
    got = (got[0], got[1], {}, got[3], {n: got[4][n] for n in before})
    want = ({k: float(ref[f"step/{k}"]) for k in ("loss", "loss_global",
                                                  "loss_local")},
            {names[k[len("step/grads/"):]]: port(k) for k in ref
             if k.startswith("step/grads/")},
            {}, before, {names[k]: port(f"step/params/{k}") for k in stored})
    lr = config.train.optimizer.lr
    row = step_errors(got, want, lr)
    row["grad_norm_rel"] = abs(float(metrics.grad_norm)
                               - float(ref["step/grad_norm"])) \
        / float(ref["step/grad_norm"])
    ema_limit = (1.0 - config.train.ema_decay) * 3.0 * lr + 1e-6
    row["ema_off"] = max(float((state.ema[names[k]].cpu()
                                - port(f"step/ema_params/{k}")).abs().max())
                         for k in stored)
    row.update(forward_excess=excess, lr_off=lr_off, ema_limit=ema_limit)
    if not row["grad_norm_rel"] <= JAX_NORM_RTOL:
        row["broken"].append("grad_norm_rel")
    if not row["ema_off"] <= ema_limit:
        row["broken"].append("ema_off")
    if not excess <= 1.0:
        row["broken"].append("forward")
    if not lr_off <= 1e-6:
        row["broken"].append("lr_off")
    return row


def run_jax_checkpoint(dev, report) -> tuple:
    """Phase 17: the converted JAX fixture resumed on the card against
    JAX's numbers, the reader's planted faults, cli/train.py resuming it
    and cli/generate.py sampling it through K1, and K1 at its width
    against the plain version. Returns (failures, K1 launches, {label: K1
    row})."""
    import shutil

    import numpy as np
    import torch

    from agdiff_torch.cli import generate as gen_cli
    from agdiff_torch.cli import train as train_cli
    from agdiff_torch.eval import generate as gen_mod
    from agdiff_torch.train.checkpoint import latest_checkpoint

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("phase 17: TF32 must be off before the gates")
    report["jax_checkpoint"] = {}
    root = os.path.join(OUT_DIR, "jax_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    log_dir = os.path.join(root, "run")
    shutil.copytree(JAX_FIXTURE, log_dir,
                    ignore=shutil.ignore_patterns("reference"))
    path, it = latest_checkpoint(log_dir)
    ref = jax_numbers()
    failures, rows = [], {}
    for fault in (None,) + JAX_FAULTS:
        label = "converted" if fault is None else f"fault {fault}"
        rows[label] = row = jax_checkpoint_row(path, ref, dev, fault)
        print(f"jax checkpoint (a) {label}: forward {row['forward_excess']:.2e}"
              f" of its limit, loss {row['loss_rel']:.2e}, grad norm "
              f"{row['grad_norm_rel']:.2e}, grads max {row['grad_max_rel']:.2e}"
              f" ({row['grad_max_rel_leaf']}), median "
              f"{row['grad_median_rel']:.2e}, p99 {row['grad_p99_rel']:.2e}, "
              f"updates off {row['update_off_share']:.2e}, EMA off "
              f"{row['ema_off']:.2e} (limit {row['ema_limit']:.2e}), lr off "
              f"{row['lr_off']:.2e}; broken {row['broken']}", flush=True)
        if fault is None and row["broken"]:
            failures.append(f"jax checkpoint (a): breaks {row['broken']}")
        if fault is not None and not row["broken"]:
            failures.append(f"jax checkpoint (a) {label}: breaks no limit")
    t0 = time.time()
    run = train_cli.main([log_dir, "--max_iters", str(it + JAX_RESUME_ITERS),
                          "--synthetic", "64", "--device", str(dev)])
    last, last_it = latest_checkpoint(log_dir)
    resumed = dict(start_iter=run.start_iter, losses=len(run.losses),
                   finite=bool(np.isfinite(run.losses).all()),
                   last_checkpoint=last_it, seconds=time.time() - t0,
                   port_state=os.path.isfile(os.path.join(last, "state.pt")))
    if (run.start_iter != it + 1 or resumed["losses"] != JAX_RESUME_ITERS
            or not resumed["finite"] or last_it != it + JAX_RESUME_ITERS
            or not resumed["port_state"]):
        failures.append(f"jax checkpoint (b) cli/train.py resume: {resumed}")
    print(f"jax checkpoint (b) cli/train.py on the converted log dir: "
          f"{resumed}", flush=True)
    out = os.path.join(root, "samples")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    with first_k1_inputs() as inputs:
        gen_cli.main([path, "--fast", "--engine", "pksf", "--dtype",
                      "bfloat16", "--synthetic", str(JAX_GEN_MOLS),
                      "--n_steps", str(JAX_GEN_STEPS), "--out_dir", out,
                      "--no_resume", "--device", str(dev)])
    torch.cuda.synchronize()
    counts = launch_counts()
    k1 = counts.pop("stack_packed/stack_full:triu", 0)
    done = gen_mod.load_samples(os.path.join(out, "samples_all.npz"))
    finite = all(np.isfinite(m.meta["pos_gen"]).all() for m in done)
    generated = dict(molecules=len(done), finite=finite, k1_launches=k1,
                     other_kernels=counts, seconds=time.time() - t0)
    if len(done) != JAX_GEN_MOLS or not finite or not k1 or counts:
        failures.append(f"jax checkpoint (c) cli/generate.py: {generated}")
    print(f"jax checkpoint (c) cli/generate.py on the converted checkpoint "
          f"(bf16, --engine pksf, {JAX_GEN_STEPS} steps): {generated}",
          flush=True)
    report["jax_checkpoint"] = dict(rows=rows, resumed=resumed,
                                    generated=generated)
    if not inputs:
        return failures + ["jax checkpoint (c): K1 never ran eagerly"], k1, {}
    # K1 at this model's width (hidden 32, where no other phase runs it)
    # against its plain version on the inputs of the ladder's first step
    kw = dict(inputs[0])
    mode, approx = kw.pop("mode"), kw.pop("approx")
    b, n = kw["h0"].shape[:2]
    label = f"jax_triu_B{b}_N{n}_H{kw['h0'].shape[2]}"
    k1_row, failed = check_k1(kw, None, label, mode, approx, QM9_LIMITS,
                              None, report)
    failures += failed
    failures += check_levels(kw, label, report, approx)
    report["jax_checkpoint"]["k1_case"] = label
    return failures, k1, {label: k1_row}


@contextlib.contextmanager
def first_k1_inputs():
    """Records a copy of K1's keyword arguments at the first launch of
    models/fast_forward.py's packed_stack_forward outside a CUDA graph's
    capture, in the list it yields."""
    import torch

    from agdiff_torch.models import fast_forward as ff

    real, inputs = ff.packed_stack_forward, []

    def record(**kw):
        if not inputs and not torch.cuda.is_current_stream_capturing():
            inputs.append({k: v.clone() if isinstance(v, torch.Tensor)
                           else v for k, v in kw.items()})
        return real(**kw)

    ff.packed_stack_forward = record
    try:
        yield inputs
    finally:
        ff.packed_stack_forward = real


def torch_equal_params(a, b) -> bool:
    """Whether two ranks' parameters after the step are equal."""
    import torch

    return all(torch.equal(a["step"][4][n], p)
               for n, p in b["step"][4].items())


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
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.models.tight_forward import build_tight_forward
    from agdiff_torch.models.weights import init_random
    from agdiff_torch.ops.pairs import pair_capacity_for
    from agdiff_torch.sampling.langevin import SamplerConfig

    started = time.time()
    # float32 products in full float32, as in the JAX reference's CPU runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "k1_checks": [], "slices": {},
              "profiles": {}, "levels": {}, "kernel_checks": [],
              "paths": {}, "build_logs": {}, "mono_checks": []}

    def dump():
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)

    report["phase_s"] = {}
    mark = [time.time()]

    def phase_done(name):
        """Record and print the seconds since the last phase ended."""
        now = time.time()
        report["phase_s"][name] = now - mark[0]
        mark[0] = now
        print(f"phase {name}: {report['phase_s'][name]:.1f} s", flush=True)
        dump()

    # ---- 2. build ----------------------------------------------------------
    t0 = time.time()
    logs = build.build_all(SOURCES)
    report["build_s"] = time.time() - t0
    report["build_logs"] = logs
    print(f"built {', '.join(SOURCES)} in parallel in "
          f"{report['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}", flush=True)
    phase_done("2 build")
    dev = torch.device("cuda")

    # ---- 3. K1 against its plain version ------------------------------------
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
        batch = random_batch(qmols, n, b, gen)
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
        batch = random_batch([mol], n, DRUGS_CHUNK, gen)
        pairs = fwd.prepare(batch, pair_capacity_for(mol.num_nodes, 256))
        kw, _ = fwd.stack_inputs(batch, pairs)
        cases[label], failed = check_k1(
            kw, batch.node_mask, label, fwd.mode, fwd.approx, DRUGS_LIMITS,
            build_tight_forward(dcfg, dcpu, engine).stack, report)
        failures += failed
        if label in ("tight_B48_N64", "tight_B48_N96"):
            failures += check_levels(kw, label, report)
    # the runner's default chunk (64, QM9 bucket 32), the QM9 server's
    # merged and solo chunks (32 and 16; 8, its smallest warmed size, runs
    # at 16's R) and a tail chunk (16, a Drugs molecule in bucket 64): the
    # wrapper's R against R / 2 and 1. The server's cases draw from a
    # generator of their own, so every other check keeps the inputs it
    # had before they were added (PERF.md section 7 has a reading of the
    # later checks on the shifted draws).
    from agdiff_torch.kernels.stack_packed import ranks_for
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tfwd = build_tight_forward(dcfg, dmodel, "tight-pksf")
    served = torch.Generator(device=dev).manual_seed(SEED)
    for label, b, drugs, draw in (("triu_B64_N32", 64, False, gen),
                                  ("triu_B32_N32", 32, False, served),
                                  ("triu_B16_N32", 16, False, served),
                                  ("tight_B16_N64", 16, True, gen)):
        forced = sorted({max(ranks_for(b, sms) // 2, 1), 1})
        if drugs:
            batch = random_batch(dmols[:1], 64, b, draw)
            pairs = tfwd.prepare(batch, pair_capacity_for(
                dmols[0].num_nodes, 256))
            kw, _ = tfwd.stack_inputs(batch, pairs)
            cases[label], failed = check_k1(
                kw, batch.node_mask, label, "full", False, DRUGS_LIMITS,
                build_tight_forward(dcfg, dcpu, "tight-pksf").stack, report,
                forced)
        else:
            batch = random_batch(qmols, 32, b, draw)
            kw, _ = qfwd.stack_inputs(batch)
            cases[label], failed = check_k1(
                kw, batch.node_mask, label, "full", False, QM9_LIMITS,
                build_fast_forward(qcfg, qcpu, "pksf").stack, report, forced)
        failures += failed
    phase_done("3 K1")

    # ---- 3b. K2-K5 against their plain versions -----------------------------
    fcfg = load_config(os.path.join(ROOT, "configs",
                                    "qm9_default.yml")).model
    fmodel = init_random(DualEncoderEpsNetwork(fcfg), SEED).to(dev).eval()
    fwds = {
        "pallas_f32": build_fast_forward(fcfg, fmodel, "pallas"),
        "pallas_bf16": build_fast_forward(qcfg, qmodel, "pallas"),
        "dense_f32": build_fast_forward(fcfg, fmodel, "pallas",
                                        pack_pairs=False),
        "dense_bf16": build_fast_forward(qcfg, qmodel, "pallas",
                                         pack_pairs=False),
        "pk": build_fast_forward(qcfg, qmodel, "pk"),
        "pk_approx": build_fast_forward(qcfg, qmodel, "pk-approx"),
    }
    qbatch = random_batch(qmols, 32, CHUNK, gen)
    new_rows, failed = check_new_kernels(fwds, qbatch, report)
    failures += failed
    phase_done("3b K2-K5")

    # ---- 4. the QM9 slice ---------------------------------------------------
    check_engines(qfwd(pad_molecules(qmols, 32, device=dev)),
                  build_fast_forward(qcfg, qmodel, None)(
                      pad_molecules(qmols, 32, device=dev)), "pksf",
                  ENGINE_TOL, report)
    runner = GenerationRunner(qmodel, qcfg, make_diffusion(qcfg),
                              SamplerConfig(n_steps=N_STEPS, w_global=0.3),
                              buckets=(32,), chunk_size=CHUNK, device=dev)
    qm9 = run_slice(runner, "pksf", qmols, CHUNK, "qm9_slice", report)

    # ---- 4b. the paths of engines 'pallas' and 'pk' -------------------------
    small = pad_molecules(qmols, 32, device=dev)
    f32_out = build_fast_forward(fcfg, fmodel, None)(small)
    check_engines(fwds["pallas_f32"](small), f32_out, "pallas_f32",
                  F32_ENGINE_TOL, report)
    check_engines(fwds["dense_f32"](small), fwds["pallas_f32"](small),
                  "pallas_f32_dense_pairs", F32_ENGINE_TOL, report)
    check_engines(fwds["pallas_bf16"](small), f32_out, "pallas_bf16",
                  ENGINE_TOL, report)
    check_engines(fwds["pk"](small), f32_out, "pk", ENGINE_TOL, report)
    fdiff = make_diffusion(fcfg)
    k3, k4, k5 = ("fused", "block_agg:"), ("fused", "pair_score:"), (
        "fused", "gine:f32")
    paths = {}
    paths["A"] = run_path("A", fwds["pallas_f32"], fdiff, qmols, PATH_STEPS,
                          {(k3[0], k3[1] + "f32"): 6, k5: 4}, report)
    paths["B"] = run_path("B", fwds["pallas_bf16"], fdiff, qmols,
                          PATH_STEPS, {(k3[0], k3[1] + "bf16"): 6}, report)
    paths["C"] = run_path("C", fwds["dense_f32"], fdiff, qmols, SHORT_STEPS,
                          {(k3[0], k3[1] + "f32"): 6, k5: 4,
                           (k4[0], k4[1] + "f32"): 2}, report)
    paths["C-bf16"] = run_path(
        "C-bf16", fwds["dense_bf16"], fdiff, qmols, SHORT_STEPS,
        {(k3[0], k3[1] + "bf16"): 6, (k4[0], k4[1] + "bf16"): 2}, report)
    for label, engine, steps in (("D", "pk", PATH_STEPS),
                                 ("D'", "pk-approx", SHORT_STEPS)):
        pk_runner = GenerationRunner(
            qmodel, qcfg, make_diffusion(qcfg),
            SamplerConfig(n_steps=steps, w_global=0.3), buckets=(32,),
            chunk_size=CHUNK, device=dev, engine=engine)
        name = ("packed_block_approx:bf16" if engine.endswith("approx")
                else "packed_block:bf16")
        paths[label] = run_path(label, pk_runner.forward(engine), fdiff,
                                qmols, steps, {("block_packed", name): 6},
                                report, runner=pk_runner)
    phase_done("4 QM9 slice and paths A-D")

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
    phase_done("5 Drugs slice")

    # ---- 5b. engine 'mono': K6 ----------------------------------------------
    mono_rows = {}
    dcfg32 = dataclasses.replace(dcfg, dtype="float32")
    for label, cfg_m, model_m, cpu_m, mols, n, b in (
            ("bf16_B128_N32", qcfg, qmodel, None, qmols, 32, CHUNK),
            ("bf16_B48_N64", dcfg, dmodel, dcpu, dmols[:1], 64, DRUGS_CHUNK),
            ("f32_B128_N32", fcfg, fmodel, None, qmols, 32, CHUNK),
            # the Drugs case at f32 too: level 1, the cosine envelope
            ("f32_B48_N64", dcfg32, dmodel, None, dmols[:1], 64,
             DRUGS_CHUNK)):
        batch = random_batch(mols, n, b, gen)
        batch = batch.replace(pos=batch.pos * MONO_POS_SCALE)
        kw, _ = build_monolithic_forward(cfg_m, model_m).kernel_inputs(batch)
        key = label.split("_")[0] + ("_drugs" if n == 64 else "")
        cpu_params = (None if cpu_m is None else
                      build_monolithic_forward(cfg_m, cpu_m).params)
        mono_rows[label], failed = check_k6(kw, label, MONO_LIMITS[key],
                                            report, cpu_params)
        failures += failed
    dump()
    fcpu = init_random(DualEncoderEpsNetwork(fcfg), SEED).eval()
    cpu_small = pad_molecules(qmols, 32)
    for lbl, cfg_m, gpu_m, cpu_m, tol in (
            ("mono", qcfg, qmodel, qcpu, ENGINE_TOL),
            ("mono_f32", fcfg, fmodel, fcpu, F32_ENGINE_TOL)):
        check_engines(build_monolithic_forward(cfg_m, gpu_m)(small),
                      build_fast_forward(cfg_m, gpu_m, None)(small), lbl,
                      tol, report)
        check_engines(build_monolithic_forward(cfg_m, cpu_m)(cpu_small),
                      build_fast_forward(cfg_m, cpu_m, None)(cpu_small),
                      f"{lbl}_plain_cpu", tol, report)
    check_engines(build_monolithic_forward(dcfg, dmodel)(one),
                  build_tight_forward(dcfg, dmodel, "tight")(one),
                  "mono_drugs", DRUGS_ENGINE_TOL, report)
    check_engines(build_monolithic_forward(dcfg, dcpu)(cpu_one),
                  build_tight_forward(dcfg, dcpu, "tight")(cpu_one),
                  "mono_drugs_plain_cpu", DRUGS_ENGINE_TOL, report)
    mono_runners = {}
    for label, cfg_m, model_m, mols, steps, buckets, chunk, var in (
            ("E", qcfg, qmodel, qmols, E_STEPS, (32,), CHUNK, "mono:bf16"),
            ("E-f32", fcfg, fmodel, qmols, SHORT_STEPS, (32,), CHUNK,
             "mono:f32"),
            ("E-drugs", dcfg, dmodel, dmols[:1], SHORT_STEPS, dconf.buckets,
             DRUGS_CHUNK, "mono:bf16")):
        mono_runners[label] = GenerationRunner(
            model_m, cfg_m, make_diffusion(cfg_m),
            SamplerConfig(n_steps=steps, w_global=0.3), buckets=buckets,
            chunk_size=chunk, device=dev, engine="mono")
        paths[label] = run_path(label, mono_runners[label].forward("mono"),
                                mono_runners[label].diffusion, mols, steps,
                                {("monolithic", var): 1}, report,
                                runner=mono_runners[label], num_confs=chunk)
    run_cli(qmodel, qcfg, qmols, report)
    phase_done("5b K6 and paths E")

    # ---- 6. where the time goes ---------------------------------------------
    k1_name = {"K1": "stack_kernel"}
    profile_slice(runner.forward("pksf"), runner.diffusion, qmols[0], 32,
                  CHUNK, "qm9", report, k1_name)
    profile_slice(drugs.forward("tight-pksf"), drugs.diffusion, dmols[0], 64,
                  DRUGS_CHUNK, "drugs", report, k1_name,
                  capacity=drugs._capacity_for(dmols[0], "tight-pksf"))
    profile_slice(fwds["pallas_f32"], fdiff, qmols[0], 32, CHUNK, "path_A",
                  report, {"K3": "block_agg_kernel", "K5": "gine_kernel"})
    profile_slice(fwds["pallas_bf16"], fdiff, qmols[0], 32, CHUNK, "path_B",
                  report, {"K3": "block_agg_kernel"})
    profile_slice(fwds["pk"], fdiff, qmols[0], 32, CHUNK, "path_D", report,
                  {"K2": "packed_block_kernel"})
    profile_slice(mono_runners["E"].forward("mono"), fdiff, qmols[0], 32,
                  CHUNK, "path_E", report, {"K6": "mono_kernel"})
    phase_done("6 profiles")

    # ---- 7. graphed ladders -------------------------------------------------
    report["graphs"] = {}
    qdiff, ddiff = make_diffusion(qcfg), make_diffusion(dcfg)
    qbig = pad_molecules([qmols[0]] * CHUNK, 32, batch_size=CHUNK,
                         device=dev)
    dbatches = [pad_molecules([m] * DRUGS_CHUNK, 64, batch_size=DRUGS_CHUNK,
                              device=dev) for m in dmols[:2]]

    def ladder(n_steps, **kw):
        return SamplerConfig(n_steps=n_steps, w_global=0.3, **kw)

    qm9_fwd = runner.forward("pksf")
    graph_case("QM9", qm9_fwd, qdiff, [qbig], ladder(GRAPH_QM9_STEPS),
               report)
    # the 50- and 56-atom molecules at one capacity: graphs keyed by
    # their tight lists, each new list's capture freeing the last one's
    graph_case("Drugs", drugs.forward("tight-pksf"), ddiff, dbatches,
               ladder(GRAPH_STEPS), report, capacity=pair_capacity_for(
                   max(m.num_nodes for m in dmols[:2]), 256))
    graph_case("E", mono_runners["E"].forward("mono"), qdiff, [qbig],
               ladder(GRAPH_STEPS), report)
    for label, key in (("C", "dense_f32"), ("C-bf16", "dense_bf16"),
                       ("D", "pk")):
        graph_case(label, fwds[key], fdiff, [qbig],
                   ladder(GRAPH_SHORT_STEPS), report)
    for label, kw in (
            ("strided_ddim_eta1", dict(ladder="strided",
                                       sampling_type="generalized",
                                       eta=1.0)),
            ("strided_heun_eta0", dict(ladder="strided",
                                       sampling_type="generalized", eta=0.0,
                                       solver="heun")),
            ("denoise_tail", dict(denoise_tail=10)),
            ("traj_stride", dict(traj_stride=10))):
        steps = GRAPH_STEPS // 2 if "heun" in label else GRAPH_STEPS
        graph_case(label, qm9_fwd, qdiff, [qbig], ladder(steps, **kw), report)
    check_runner_warm(qmodel, qcfg, qmols, report)
    # 20 graphed steps of each path: idle share, capture time, and each
    # hand kernel's launches in the window against those the replays ran
    for label, fwd_g, diff_g, mol, bucket, chunk, names, cap in (
            ("graph_qm9", qm9_fwd, qdiff, qmols[0], 32, CHUNK, k1_name,
             None),
            ("graph_drugs", drugs.forward("tight-pksf"), ddiff, dmols[0], 64,
             DRUGS_CHUNK, k1_name,
             drugs._capacity_for(dmols[0], "tight-pksf")),
            ("graph_path_E", mono_runners["E"].forward("mono"), fdiff,
             qmols[0], 32, CHUNK, {"K6": "mono_kernel"}, None),
            ("graph_path_C", fwds["dense_f32"], fdiff, qmols[0], 32, CHUNK,
             {"K3": "block_agg_kernel", "K4": "pair_score_kernel",
              "K5": "gine_kernel"}, None),
            ("graph_path_C-bf16", fwds["dense_bf16"], fdiff, qmols[0], 32,
             CHUNK, {"K3": "block_agg_kernel", "K4": "pair_score_kernel"},
             None),
            ("graph_path_D", fwds["pk"], fdiff, qmols[0], 32, CHUNK,
             {"K2": "packed_block_kernel"}, None)):
        row = profile_slice(fwd_g, diff_g, mol, bucket, chunk, label, report,
                            names, capacity=cap, graph=True)
        if row is None or row["launches_seen"] != row["launches_replayed"] \
                or not all(row["launches_seen"].values()):
            failures.append(f"{label}: the replays' profile shows "
                            f"{row and row['launches_seen']}, the replays "
                            f"ran {row and row['launches_replayed']}")
    for label, prof in (("QM9", "graph_qm9"), ("Drugs", "graph_drugs"),
                        ("E", "graph_path_E"), ("C-bf16",
                                                "graph_path_C-bf16")):
        g, p = report["graphs"][label], report["profiles"][prof]
        print(f"graphed {label}: {g['ms_per_step_graphed']:.3f} ms/step "
              f"(eager {g['ms_per_step_eager']:.3f}), capture "
              f"{g['capture_s']:.3f} s; 20 graphed steps: idle share "
              f"{p['idle_share']:.3f}, between kernels {p['gap_share']:.3f} "
              f"({card})", flush=True)
    # the NaN guard: each graphed path's kernels against their plain twins
    # on planted positions, K4 and K5 with a NaN off the mask, then two
    # random-weight ladders through the runner
    drugs_cap = pair_capacity_for(dmols[0].num_nodes, 256)
    for label, fwd_g, diff_g, batch_g, cfg_g, cap, relu in (
            ("QM9", qm9_fwd, qdiff, qbig, ladder(NAN_STEPS), None, True),
            ("QM9 strided_ddim_eta1", qm9_fwd, qdiff, qbig, ladder(
                NAN_STEPS, ladder="strided", sampling_type="generalized",
                eta=1.0), None, True),
            ("QM9 strided_heun_eta0", qm9_fwd, qdiff, qbig, ladder(
                NAN_STEPS, ladder="strided", sampling_type="generalized",
                eta=0.0, solver="heun"), None, True),
            ("QM9 denoise_tail", qm9_fwd, qdiff, qbig,
             ladder(NAN_STEPS, denoise_tail=2), None, True),
            ("QM9 traj_stride", qm9_fwd, qdiff, qbig,
             ladder(NAN_STEPS, traj_stride=2), None, True),
            ("Drugs", drugs.forward("tight-pksf"), ddiff, dbatches[0],
             ladder(NAN_STEPS), drugs_cap, True),
            ("E", mono_runners["E"].forward("mono"), qdiff, qbig,
             ladder(NAN_STEPS), None, True),
            ("C", fwds["dense_f32"], fdiff, qbig, ladder(NAN_STEPS), None,
             True),
            ("C-bf16", fwds["dense_bf16"], fdiff, qbig, ladder(NAN_STEPS),
             None, True),
            ("D", fwds["pk"], fdiff, qbig, ladder(NAN_STEPS), None, False)):
        failures += nan_gate(label, fwd_g, diff_g, batch_g, cfg_g, report,
                             capacity=cap, relu=relu)
    failures += nan_off_mask(fwds, qbatch, report)
    for label, model_g, cfg_g, buckets, chunk, mols_g, steps in (
            ("QM9 pksf", qmodel, qcfg, (32,), CHUNK, qmols[:1],
             GRAPH_QM9_STEPS),
            ("Drugs tight-pksf", dmodel, dcfg, dconf.buckets, DRUGS_CHUNK,
             dmols[:1], GRAPH_STEPS)):
        failures += runner_guard(label, GenerationRunner(
            model_g, cfg_g, make_diffusion(cfg_g), ladder(steps),
            buckets=buckets, chunk_size=chunk, device=dev), mols_g, chunk,
            report)
    phase_done("7 graphs and the NaN guard")

    # ---- 8. the test set: generate, then score ------------------------------
    failures += run_test_set(qmodel, qcfg, dmodel, dconf, report, dev)
    phase_done("8 test set")

    # ---- 9. training --------------------------------------------------------
    failures += run_training(dev, report)
    phase_done("9 train")

    # ---- 10. the generation server; the engines of JAX's XLA path --------
    report["serve"], report["engines"] = {}, {}
    failures += serve_qm9(qmodel, qcfg, qmols, dmols, dev, report)
    failures += serve_drugs(dmodel, dconf, dmols, dev, report)
    failures += serve_cli(report)
    failures += run_engines(
        {"qm9": (qcfg, qmodel, qcpu, (32,), CHUNK),
         "qm9_f32": (fcfg, fmodel, None, (32,), CHUNK),
         "drugs": (dcfg, dmodel, dcpu, dconf.buckets, DRUGS_CHUNK)},
        {"qm9": qmols, "drugs": dmols}, dev, report)
    phase_done("10 serve and engines")

    # ---- 11. bf16 training, distillation and the distilled student --------
    failed, k1_student = run_distillation(dev, report)
    failures += failed
    phase_done("11 bf16 train, distill, student")

    # ---- 12. data parallelism -----------------------------------------------
    failed, k1_dp_triu, k1_dp_tight = run_data_parallel(
        qcfg, qmols, dcfg, dconf, dmols, dev, report)
    failures += failed
    phase_done("12 data parallelism")

    # ---- 13. configuration variants: gelu heads, gaussian, .pkl ------------
    failed, gelu_k1, gelu_k4, gelu_k6, gelu_launches = run_variants(
        qcfg, dconf, fcfg, qmols, dmols, dev, gen, report, dump)
    failures += failed
    cases.update(gelu_k1)
    new_rows.update(gelu_k4)
    mono_rows.update(gelu_k6)
    phase_done("13 configuration variants")

    # ---- 14. sharded and pipelined training layouts --------------------------
    train_cases = dp_train_cases(dev)
    failed, k3_pipeline = run_sharded(qcfg, qmols, dev, gen, report,
                                      train_cases)
    failures += failed
    phase_done("14 sharded and pipelined")

    # ---- 15. spatial sharding and the protein path -------------------------
    failed, k1_protein = run_spatial(qcfg, qmodel, train_cases[0], dev,
                                     report)
    failures += failed
    phase_done("15 spatial sharding and protein path")

    # ---- 16. the host modules and the RDKit seam ---------------------------
    failed, k1_host = run_host(qcfg, qmodel, qmols, dev, report)
    failures += failed
    phase_done("16 host modules and the RDKit seam")

    # ---- 17. a checkpoint of the JAX package in the port --------------------
    failed, k1_jax, jax_k1 = run_jax_checkpoint(dev, report)
    failures += failed
    cases.update(jax_k1)
    phase_done("17 JAX checkpoint")
    if failures:
        raise SystemExit("\n".join(failures))

    # ---- 18. result lines --------------------------------------------------
    def entry(name, case, launches, also=()):
        """K1's row: times and bound of `case`, the largest error of it
        and of the cases `also` (the other batch sizes the path runs)."""
        c = cases[case]
        return dict(name=name, route="cuda",
                    source="agdiff_torch/kernels/csrc/stack_packed.cu",
                    replaces="agdiff_tpu/ops/pallas/stack_packed.py:104",
                    launches=launches, max_abs_err=max(
                        cases[k]["max_abs_err"] for k in (case, *also)),
                    ms=c["ms"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                    library_ms=None)

    def new_entry(name, launches, source):
        c = new_rows[name]
        return dict(name=name, route="cuda", source=source,
                    replaces=REPLACES[name.split(":")[0]],
                    launches=launches, max_abs_err=c["max_abs_err"],
                    ms=c["ms"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                    library_ms=None)

    def path_launches(name, labels):
        return sum(paths[p]["launches"].get(name, 0) for p in labels)

    fused_src = "agdiff_torch/kernels/csrc/fused.cu"
    kernels = [
        entry("stack_full:triu", "triu_B128_N32", qm9["k1_launches"]
              + report["serve"]["qm9"]["k1_launches"]
              + report["engines"]["pksf-e16"]["k1_launches"]
              + k1_student + k1_dp_triu + k1_protein + k1_host + k1_jax,
              ("triu_B64_N32", "triu_B32_N32", "triu_B16_N32", *jax_k1)),
        entry("stack_full:tight", "tight_B48_N64",
              slices["drugs_bucket64"]["k1_launches"]
              + slices["drugs_above64"]["k1_launches"]
              + report["serve"]["drugs"]["k1_launches"]
              + report["engines"]["tight-pksf-e16"]["k1_launches"]
              + k1_dp_tight,
              ("tight_B16_N64", "tight_B48_N96")),
        entry("stack_schnet:tight", "schnet_B48_N64",
              slices["tight-pks"]["k1_launches"]),
        entry("stack_gin:tight", "gin_B48_N64",
              slices["tight-pksg"]["k1_launches"]),
        entry("stack_full_approx:tight", "full_approx_B48_N64",
              slices["tight-pksf-approx"]["k1_launches"]),
        new_entry("block_agg:f32", path_launches(
            "fused/block_agg:f32", ("A", "C")), fused_src),
        new_entry("block_agg:bf16", path_launches(
            "fused/block_agg:bf16", ("B", "C-bf16")) + k3_pipeline,
            fused_src),
        new_entry("pair_score:f32", path_launches(
            "fused/pair_score:f32", ("C",)), fused_src),
        new_entry("pair_score:bf16", path_launches(
            "fused/pair_score:bf16", ("C-bf16",)), fused_src),
        new_entry("gine:f32", path_launches("fused/gine:f32", ("A", "C")),
                  fused_src),
        new_entry("packed_block:bf16", path_launches(
            "block_packed/packed_block:bf16", ("D",)),
            "agdiff_torch/kernels/csrc/block_packed.cu"),
        new_entry("packed_block_approx:bf16", path_launches(
            "block_packed/packed_block_approx:bf16", ("D'",)),
            "agdiff_torch/kernels/csrc/block_packed.cu"),
    ]
    kernels += [entry(name, case, gelu_launches[name]) for name, case in (
        ("stack_full_gelu:triu", "gelu_triu_B128_N32"),
        ("stack_full_gelu_approx:triu", "gelu_approx_triu_B128_N32"),
        ("stack_full_gelu:tight", "gelu_tight_B48_N64"),
        ("stack_full_gelu_approx:tight", "gelu_approx_tight_B48_N64"))]
    kernels += [new_entry(name, gelu_launches[name], fused_src)
                for name in ("pair_score_gelu:f32", "pair_score_gelu:bf16")]
    for name, case, launched in (
            ("mono:bf16", "bf16_B128_N32", path_launches(
                "monolithic/mono:bf16", ("E", "E-drugs"))),
            ("mono:f32", "f32_B128_N32", path_launches(
                "monolithic/mono:f32", ("E-f32",))),
            ("mono_gelu:bf16", "gelu_bf16_B128_N32",
             gelu_launches["mono_gelu:bf16"]),
            ("mono_gelu:f32", "gelu_f32_B128_N32",
             gelu_launches["mono_gelu:f32"])):
        c = mono_rows[case]
        kernels.append(dict(
            name=name, route="cuda",
            source="agdiff_torch/kernels/csrc/mono.cu",
            replaces=REPLACES["mono"],
            launches=launched,
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=None))
    report["kernels"] = kernels
    report["total_s"] = time.time() - started
    dump()
    print(f"chip_smoke.py ran {report['total_s']:.1f} s, the build "
          f"{report['build_s']:.1f} s of it", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
