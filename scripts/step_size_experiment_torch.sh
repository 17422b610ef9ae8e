#!/usr/bin/env bash
# The adapted-step-size experiment on the CPU: both packages' headline
# benches on the same real pixels (BENCH_DATASET=digits: the JAX bench then
# takes its f32 "xla vmapped" path, not the bf16-pass Pallas kernel), the same
# chains, warmup and draws, several seeds each.  Prints one JSON line per run
# and then a summary of median step size, acceptance and median / min ESS per
# draw for each package.
#
# The JAX bench has fixed keys, so it runs from a COPY in a temporary
# directory whose keys take an offset from BENCH_SEED_OFFSET; nothing in the
# repository is edited, and the copy's caches go with the directory.
#
# Usage: bash scripts/step_size_experiment_torch.sh [chains] [warmup] [draws] [seeds] [first seed]
set -eu -o pipefail
cd "$(dirname "$0")/.."
REPO=$PWD
CHAINS=${1:-8}; WARMUP=${2:-300}; DRAWS=${3:-1000}; SEEDS=${4:-3}; FIRST=${5:-0}
PY=${PYTHON:-python}
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT

mkdir -p "$WORK/jax"
cp -r "$REPO/dropout_hamiltonian_montecarlo_tpu" "$WORK/jax/"
sed 's/jax\.random\.key(\([0-9]\))/jax.random.key(\1 + 10 * int(os.environ.get("BENCH_SEED_OFFSET", "0")))/' \
    "$REPO/bench.py" > "$WORK/jax/bench.py"

export BENCH_DATASET=digits BENCH_CHAINS=$CHAINS BENCH_WARMUP=$WARMUP BENCH_DRAWS=$DRAWS
export JAX_PLATFORMS=cpu BENCH_SETUP_CACHE=0
for s in $(seq "$FIRST" $((FIRST + SEEDS - 1))); do
  # the JAX bench logs its adapted step sizes (stderr) and keeps them out of
  # its JSON line: carry the logged median into the line
  (cd "$WORK/jax" && BENCH_SEED_OFFSET=$s "$PY" bench.py 2>"$WORK/jax_$s.log" | tail -1 \
     > "$WORK/jax_$s.json")
  step=$(sed -n 's/.*step size median=\([0-9.]*\).*/\1/p' "$WORK/jax_$s.log" | head -1)
  sed "s/^{/{\"package\": \"jax\", \"seed\": $s, \"step_size_median\": $step, /" \
      "$WORK/jax_$s.json" | tee -a "$WORK/lines.jsonl"
  "$PY" -c "
import json
from dropout_hamiltonian_montecarlo_tpu_torch import bench
r = bench.run(device='cpu', seed=$s + 1, dataset='digits', chains=$CHAINS, warmup=$WARMUP,
              draws=$DRAWS)
print(json.dumps(dict({'package': 'torch', 'seed': $s}, **r)))" 2>"$WORK/torch_$s.log" \
     | tee -a "$WORK/lines.jsonl"
done

"$PY" - "$WORK/lines.jsonl" <<'PYEOF'
import json, sys
import numpy as np
rows = [json.loads(line) for line in open(sys.argv[1])]
for package in ("jax", "torch"):
    det = []
    for r in (r for r in rows if r["package"] == package):
        d = r["detail"]
        cap = d["ess_cap_chains_x_draws"]
        det.append({"step_size_median": r.get("step_size_median", d.get("step_size_median")),
                    "acceptance": d["acceptance"], "divergent_frac": d["divergent_frac"],
                    "ess_median_frac_of_cap": d["ess_median"] / cap,
                    "ess_min_frac_of_cap": d["ess_min"] / cap, "path": d["path"]})
    summary = {"package": package, "runs": len(det), "path": sorted({d["path"] for d in det})}
    for key in ("step_size_median", "acceptance", "ess_median_frac_of_cap",
                "ess_min_frac_of_cap", "divergent_frac"):
        values = [d[key] for d in det]
        summary[key] = {"median": float(np.median(values)), "min": float(min(values)),
                        "max": float(max(values))}
    print(json.dumps(summary))
PYEOF
