#!/usr/bin/env bash
# Run the six workload configs of the PyTorch / CUDA port end to end through
# its CLI (dhmc-torch) and print one JSON summary line per config: the twin
# of scripts/run_configs.sh for the port.  Each line carries the dataset's
# provenance and the device's name.
#
# Usage: bash scripts/run_configs_torch.sh [outfile] [extra CLI options]
#   bash scripts/run_configs_torch.sh                 # on the card, to stdout
#   bash scripts/run_configs_torch.sh results.jsonl   # also appended to a file
#   bash scripts/run_configs_torch.sh - --device cpu  # name the CPU (slow at
#                                                     # these sizes)
# --shard-particles and the other multi-device options are left out: the
# port's parallel layer is not there yet.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT="${1:--}"
shift || true
EXTRA=("$@")
PY=${PYTHON:-python}
ERR=$(mktemp -d)
trap 'rm -rf "$ERR"' EXIT
failed=0

run() {
  local name="$1"; shift
  echo "== $name: $*" >&2
  local t0=$SECONDS line rc
  line=$("$PY" -m dropout_hamiltonian_montecarlo_tpu_torch.cli "$@" "${EXTRA[@]}" \
         2>"$ERR/$name.log" | tail -1)
  rc=$?
  local dt=$((SECONDS - t0))
  if [ $rc -ne 0 ] || [ -z "$line" ]; then
    echo "   FAILED (rc=$rc, ${dt}s); stderr tail:" >&2
    tail -5 "$ERR/$name.log" >&2
    line="{\"config\": \"$name\", \"failed\": true, \"rc\": $rc, \"wall_s\": $dt}"
    failed=1
  else
    echo "   ok (${dt}s)" >&2
    line="{\"config\": \"$name\", \"wall_s\": $dt, \"result\": $line}"
  fi
  echo "$line"
  if [ "$OUT" != "-" ]; then echo "$line" >> "$OUT"; fi
}

# config 1: 2-D MVN target, HMC
run config1-mvn-hmc mvn-hmc --dim 2 --chains 4 --samples 1000 --warmup 300
# config 2: Bayesian logistic regression on simulated blobs, 32 chains
run config2-logistic-hmc logistic-hmc --chains 32 --samples 1000 --warmup 300
# config 3: MNIST softmax, lockstep chain-batched NUTS on the fused kernel,
# 128 chains x 1000 draws in chunks of 50 (the draws stay in the bounded
# buffer; pass --save FILE --checkpoint FILE to spool and checkpoint them)
run config3-mnist-nuts mnist-nuts --chains 128 --samples 1000 --warmup 150 \
    --max-depth 6 --stream-chunk 50
# config 3b: the same pipeline on real bundled pixels (scikit-learn's digits)
run config3b-digits-nuts mnist-nuts --dataset digits --chains 64 \
    --samples 500 --warmup 150 --max-depth 6
# config 4: MNIST dropout MLP, minibatch SGHMC with the masks in the potential
run config4-mlp-sghmc mnist-mlp-sgmcmc --algorithm sghmc --chains 16 \
    --collect-every 20
# config 4b: the same with SGLD (step 1e-6: no friction damps the gradient)
run config4b-mlp-sgld mnist-mlp-sgmcmc --algorithm sgld --step-size 1e-6 \
    --chains 16 --collect-every 20
# config 5: PlantVillage-shaped conv features, tempered SMC, HMC mutation
run config5-plantvillage-smc plantvillage-smc --particles 256 --n-data 5000
# config 5b: minibatch SGHMC mutation
run config5b-smc-sghmc plantvillage-smc --particles 256 --n-data 5000 \
    --mutation sghmc --batch-size 1024 --step-size 1e-3 --mcmc-steps 40
# config 6: mean-field ADVI on the softmax and on the MLP
run config6-mnist-vi-softmax mnist-vi --model softmax
run config6b-mnist-vi-mlp mnist-vi --model mlp --init-log-std -6 \
    --learning-rate 3e-3 --num-steps 4000

exit $failed
