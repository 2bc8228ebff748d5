#!/usr/bin/env bash
# Checks the PyTorch/CUDA port on a card from a copy of the committed files.
#
#   git add -A && mkdir -p results/archive &&
#     git archive "$(git write-tree)" | tar -x -C results/archive
#   bash tools/chip_check.sh results/archive
#
# In that copy it runs chip_smoke.py, then chip_smoke.py alone in an empty
# directory (it must exit non-zero and print no result), the card-only tests
# (pytest -m cuda tests/test_torch_cuda.py) and the searchers' host-time split
# (python -m repro_torch.cuda_bench.search_cost). Full logs go to
# chiprun_out/check/; the summary printed at the end quotes the lines each
# step is judged by. Exits non-zero if any step fails.
set -u
tree=$(cd "${1:?usage: chip_check.sh <copy of the committed tree>}" && pwd)
out="$PWD/chiprun_out/check"
alone="$PWD/results/alone"
mkdir -p "$out"
rm -rf "$alone" && mkdir -p "$alone" && cp "$tree/chip_smoke.py" "$alone/"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"

t0=$(date +%s%N)
(cd "$tree" && python3 chip_smoke.py) >"$out/smoke.log" 2>&1; smoke=$?
smoke_ms=$(( ($(date +%s%N) - t0) / 1000000 ))
(cd "$alone" && python3 chip_smoke.py) >"$out/alone.log" 2>&1; alone_rc=$?
(cd "$tree" && PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py) \
  >"$out/pytest_cuda.log" 2>&1; pytest_rc=$?
(cd "$tree" && PYTHONPATH=src python3 -m repro_torch.cuda_bench.search_cost) \
  >"$out/search_cost.log" 2>&1; cost_rc=$?

echo "== chip_smoke.py exit $smoke in $smoke_ms ms; its tune, matrix and phase lines, its card line and its last line:"
grep -E '^ *(tune|matrix) |^phase wall' "$out/smoke.log"
grep -F "$(cat "$out/card.txt")" "$out/smoke.log" | tail -n 1
tail -n 1 "$out/smoke.log"
echo "== chip_smoke.py alone in an empty directory: exit $alone_rc; last line:"
tail -n 1 "$out/alone.log"
echo "== pytest -m cuda tests/test_torch_cuda.py: exit $pytest_rc; summary:"
tail -n 1 "$out/pytest_cuda.log"
echo "== search_cost: exit $cost_rc"
cat "$out/search_cost.log"

ok=0
[ "$smoke" -eq 0 ] || ok=1
[ "$alone_rc" -ne 0 ] || ok=1
grep -q '"ok": true' "$out/alone.log" && ok=1
[ "$pytest_rc" -eq 0 ] || ok=1
[ "$cost_rc" -eq 0 ] || ok=1
echo "== chip_check: $([ $ok -eq 0 ] && echo passed || echo FAILED)"
exit $ok
