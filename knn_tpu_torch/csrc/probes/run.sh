#!/bin/bash
# Builds and runs the microbenchmarks of this directory on the visible GPU
# (nvcc from PATH or /usr/local/cuda), into a temporary directory; prints
# the card's name and power limit, then each probe's JSON lines.
#   bash knn_tpu_torch/csrc/probes/run.sh
set -euo pipefail
here="$(cd "$(dirname "$0")" && pwd)"
out="$(mktemp -d)"
trap 'rm -rf "$out"' EXIT
export PATH="$PATH:/usr/local/cuda/bin"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for probe in dmma_shapes redux_rate; do
  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
    -o "$out/$probe" "$here/$probe.cu"
  "$out/$probe"
done
