#!/bin/bash
# Runs one `chip_smoke.py --only` phase in two trees in turns on one card:
# A, B, B, A, a process each, so that neither tree always runs first.
#
#   tools/turns.sh PHASE TREE_A TAG_A TREE_B TAG_B
#
# A tree is a checkout of the repository (for example an earlier commit's
# `git archive`, unpacked in a directory that .gitignore lists) with the
# same chip_smoke.py copied in. Each run's output goes to
# chiprun_out/PHASE_TAG1.log / PHASE_TAG2.log; one line a run (its exit
# code and the end of its last JSON line) goes to standard output. Exits
# with the first failing run's code, after all four ran.
set -u
[ $# -eq 5 ] || { echo "usage: $0 PHASE TREE_A TAG_A TREE_B TAG_B" >&2; exit 2; }
phase=$1
out=$(pwd)/chiprun_out
mkdir -p "$out"
status=0
run() {  # tree tag
  (cd "$1" && python3 chip_smoke.py --only "$phase") > "$out/${phase}_$2.log" 2>&1
  local rc=$?
  echo "$phase $2 rc=$rc $(grep '^{' "$out/${phase}_$2.log" | tail -1 | cut -c1-100)"
  [ $status -ne 0 ] || status=$rc
}
run "$2" "${3}1"
run "$4" "${5}1"
run "$4" "${5}2"
run "$2" "${3}2"
exit $status
