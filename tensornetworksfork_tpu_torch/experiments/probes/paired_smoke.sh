#!/usr/bin/env bash
# Compare two trees of the repository on one card: run chip_smoke.py from
# each in turns (A, B, B, A), then the card tests from B, then chip_smoke.py
# alone in an empty directory (which must fail). Each tree builds its own
# kernel library under its own build/. Full logs go to OUT; the lines that
# carry the numbers are printed.
#
#   git archive <parent> | tar -x -C build/parent
#   git archive $(git write-tree) | tar -x -C build/change
#   bash tensornetworksfork_tpu_torch/experiments/probes/paired_smoke.sh \
#       build/parent build/change chiprun_out/paired
set -u
A=$(realpath "$1")
B=$(realpath "$2")
mkdir -p "$3"
OUT=$(realpath "$3")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for tree in "$A" "$B" "$B" "$A"; do
  i=$((i + 1))
  log="$OUT/smoke_${i}_$(basename "$tree").log"
  (cd "$tree" && timeout 900 python3 chip_smoke.py > "$log" 2>&1)
  echo "== run $i ($(basename "$tree")): rc=$?"
  grep -E "^\[build\] /|spill stores|\[slice\]|\[regression\] (fit|swipe)|\[reference\]|\[kernels\] (retile_hmix|quantize_tiled|gram_pair_q|gram_pair_tiled|gram_pair|retile_rows|weighted_gram|own_out_gram):|^\{\"ok\"|Error|error" "$log" \
    | grep -vE " 0 bytes spill stores" | cut -c1-600
done
(cd "$B" && timeout 600 python3 -m pytest --noconftest -p no:cacheprovider -q \
  tests/test_torch_cuda.py > "$OUT/cuda_tests.log" 2>&1)
echo "== card tests: rc=$?"
tail -3 "$OUT/cuda_tests.log"
alone=$(mktemp -d)
cp "$B/chip_smoke.py" "$alone/"
(cd "$alone" && timeout 120 python3 chip_smoke.py > "$OUT/alone.log" 2>&1)
echo "== chip_smoke.py alone: rc=$? (must be nonzero)"
tail -2 "$OUT/alone.log"
rm -rf "$alone"
