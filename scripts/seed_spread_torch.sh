#!/usr/bin/env bash
# Seed spreads of ADVI (config 6) and tempered SMC (config 5) on the CPU, for
# both packages at a reduced size: `mnist-vi --model softmax --dataset digits`
# with fewer steps and `plantvillage-smc --n-data 400 --particles 32`, the
# same options and seeds for each package's CLI.  Prints one JSON line per
# run, then per package and workload the median, min and max of the
# predictive accuracy and NLL (ADVI) and of the log evidence and stage count
# (SMC).
#
# Usage: bash scripts/seed_spread_torch.sh [seeds] [first seed] [vi steps]
set -eu -o pipefail
cd "$(dirname "$0")/.."
SEEDS=${1:-8}; FIRST=${2:-0}; VI_STEPS=${3:-800}
PY=${PYTHON:-python}
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
export JAX_PLATFORMS=cpu

VI=(mnist-vi --model softmax --dataset digits --num-steps "$VI_STEPS" --batch-size 256
    --learning-rate 0.02)
SMC=(plantvillage-smc --n-data 400 --particles 32)
for s in $(seq "$FIRST" $((FIRST + SEEDS - 1))); do
  for pkg in jax torch; do
    if [ "$pkg" = jax ]; then
      run=("$PY" -m dropout_hamiltonian_montecarlo_tpu.cli); dev=()
    else
      run=("$PY" -m dropout_hamiltonian_montecarlo_tpu_torch.cli); dev=(--device cpu)
    fi
    for w in VI SMC; do
      declare -n args=$w
      "${run[@]}" "${args[@]}" --seed "$s" "${dev[@]}" 2>/dev/null | tail -1 \
        | sed "s/^{/{\"package\": \"$pkg\", \"seed\": $s, /" | tee -a "$WORK/lines.jsonl"
    done
  done
done

"$PY" - "$WORK/lines.jsonl" <<'PYEOF'
import json, sys
import numpy as np
rows = [json.loads(line) for line in open(sys.argv[1])]
keys = {"mnist-vi-softmax": ("predictive_accuracy", "predictive_nll"),
        "plantvillage-smc": ("log_evidence", "num_stages")}
for workload, fields in keys.items():
    for package in ("jax", "torch"):
        sel = [r for r in rows if r["package"] == package and r["workload"] == workload]
        summary = {"package": package, "workload": workload, "runs": len(sel)}
        for f in fields:
            v = [r[f] for r in sel]
            summary[f] = {"median": float(np.median(v)), "min": float(min(v)),
                          "max": float(max(v)), "mean": float(np.mean(v)),
                          "std": float(np.std(v, ddof=1))}
        print(json.dumps(summary))
PYEOF
