#!/bin/bash
# The runs that prove one cell, from the root of a checkout on a machine
# with the card:
#
#   bash bench/tools/prove_cell.sh <cell> <first seed> <seconds> <out dir>
#
# two sets of six runs at the same six seeds (seed+1 .. seed+6), then
# three traced runs (seed+7 .. seed+9) and three short runs of 10 s
# (seed+10 .. seed+12), in that order.  Each run's standard output and
# error go to <out dir>/r<i>.out and .err; a line per run with its exit
# code and wall milliseconds, its result line and its checks go to standard
# output.  Then: python3 bench/tools/spread.py <out dir>/r{1..6}.out -- <out dir>/r{7..12}.out
c=$1; b=$2; s=$3; out=$4
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
run() {
    i=$((i + 1))
    local t0 t1 rc
    t0=$(date +%s%N)
    timeout 400 python3 bench/run.py "$@" > "$out/r$i.out" 2> "$out/r$i.err"
    rc=$?
    t1=$(date +%s%N)
    echo "rc=$rc wall_ms=$(( (t1 - t0) / 1000000 )) $*"
    tail -n 1 "$out/r$i.out" | cut -c1-3000
    tail -n 3 "$out/r$i.err"
}
for set in A B; do
    for k in 1 2 3 4 5 6; do run --workload "$c" --seed $((b + k)) --seconds "$s" --trace 0; done
done
for k in 7 8 9; do run --workload "$c" --seed $((b + k)) --seconds "$s" --trace 1; done
for k in 10 11 12; do run --workload "$c" --seed $((b + k)) --seconds 10 --trace 0; done
