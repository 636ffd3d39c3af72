#!/bin/bash
# The README's QM9 recipe through the port's CLIs on the card: train
# configs/qm9_fast.yml (15000 iterations), distill its EMA shadow into
# n64 -> n32 -> n16 students (1000 iterations a stage), then score on the
# generation CLI's 60 held-out synthetic molecules (seed 7, 3 references,
# 2x conformers) with --w_global 0.3 --clip_local 20, strided DDIM eta 0:
# the n16 student on pksf, the undistilled EMA teacher at n16 on pksf,
# and the same teacher at f32 (the f32 engine).
#
#   bash agdiff_torch/scripts/rehearsal_qm9_fast.sh [OUT_DIR]
#
# from the root of the repository, on a CUDA card (48 min on an NVIDIA
# H100 80GB HBM3 at 700 W).
# OUT_DIR (default rehearsal/) gets the logs, the samples and their
# COV/MAT; the checkpoints are deleted at the end.
set -u
R=${1:-rehearsal}
rm -rf "$R"; mkdir -p "$R"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
T0=$(date +%s)
python -m agdiff_torch.cli.train configs/qm9_fast.yml --synthetic 2048 \
    --max_iters 15000 --logdir $R/logs > $R/train.log 2>&1
echo "train rc=$? $(( $(date +%s) - T0 )) s"
LOG=$(ls -d $R/logs/qm9_fast_* | tail -1)
grep -E "Validate|it/s" $R/train.log | tail -4
T0=$(date +%s)
python -m agdiff_torch.cli.distill $LOG --ema_teacher --stages 64,32,16 \
    --iters 1000 --synthetic 2048 --logdir $R/distill > $R/distill.log 2>&1
echo "distill rc=$? $(( $(date +%s) - T0 )) s"
grep -E "done|it/s" $R/distill.log | tail -8
LADDER="--fast --sampling_type generalized --eta 0 --ladder strided --n_steps 16 --w_global 0.3 --clip_local 20 --synthetic 60 --end_idx 60 --packed --no_resume"
for arm in student16 teacher16 teacher16_f32; do
  case $arm in
    student16) SRC="$R/distill/stage16"; EXTRA="";;
    teacher16) SRC="$LOG"; EXTRA="--ema";;
    teacher16_f32) SRC="$LOG"; EXTRA="--ema --dtype float32";;
  esac
  T0=$(date +%s)
  python -m agdiff_torch.cli.generate $SRC $EXTRA $LADDER \
      --out_dir $R/$arm > $R/$arm.log 2>&1
  echo "$arm generate rc=$? $(( $(date +%s) - T0 )) s"
  python -m agdiff_torch.cli.eval_covmat $R/$arm/samples_all.npz \
      --num_workers 8 >> $R/$arm.log 2>&1
  echo "$arm eval rc=$?"
  grep -E "MAT|COV" $R/$arm.log | tail -6
done
R="$R" python - <<'PY'
import os
import numpy as np
R = os.environ["R"]
res = {}
for arm in ("student16", "teacher16", "teacher16_f32"):
    with np.load(f"{R}/{arm}/samples_all_covmat.npz") as d:
        thr = d["thresholds"]; k = int(np.argmin(np.abs(thr - 0.5)))
        res[arm] = (d["MatchingR"], d["CoverageR"][:, k], thr[k])
        print(arm, "molecules", len(d["MatchingR"]), "MAT-R mean %.4f median %.4f" % (d["MatchingR"].mean(), np.median(d["MatchingR"])), "COV-R@%.2f %.4f" % (thr[k], d["CoverageR"][:, k].mean()))
for a, b in (("student16", "teacher16"), ("teacher16", "teacher16_f32")):
    d = res[a][0] - res[b][0]
    print(f"paired MAT-R {a} - {b}: mean {d.mean():.4f} sd/sqrt(n) {d.std(ddof=1)/np.sqrt(len(d)):.4f}")
PY
# the checkpoints (tens of MB each) go; the logs and sample scores stay
find $R -name checkpoints -type d -prune -exec rm -rf {} +
find $R -name best_model -type d -prune -exec rm -rf {} +
du -sh $R
