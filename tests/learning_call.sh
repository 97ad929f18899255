#!/bin/bash
# One learning call on the card, run from the repo's root:
#
#   bash tests/learning_call.sh OUT DEADLINE JOBS
#
# Unpacks every resume_in/states/<run>.<iteration>.pt.xz (from an earlier
# call's tests/pack_states.py) into resume_in/unpacked/<run>/, the path a
# resumed job names as --resume, builds the flood kernel, runs the trainer
# jobs of JOBS (tests/run_slots.py's format, each from the repo's root)
# four at a time against DEADLINE seconds with their logs in
# resume_in/runs/<OUT's name>/, then gathers under OUT every run's records
# and best tracker, its newest state (lzma) and its best target, in that
# order, within the 64 MiB a call brings back. Everything it writes stays
# inside the checkout, under the gitignored resume_in/ and OUT. STATES
# moves the packed states' dir; NO_BUILD=1 skips the kernel build (a CPU
# rehearsal with --device cpu jobs).
set -u
OUT=$1; DEADLINE=$2; JOBS=$3
cd "$(dirname "$0")/.."
LOG=$PWD/resume_in/runs/$(basename "$OUT")
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  | tee "$OUT/card.txt"
python3 -c 'import sys, torch
print(sys.version, torch.__version__, torch.version.cuda)'
for s in "${STATES:-resume_in/states}"/*.pt.xz; do
  [ -e "$s" ] || continue
  run=$(basename "$s"); run=${run%%.*}
  python3 tests/pack_states.py --unpack "$s" "resume_in/unpacked/$run"
  echo "UNPACKED $s -> resume_in/unpacked/$run"
done
if [ -z "${NO_BUILD:-}" ]; then
  python3 -c "from active_tracking_rl_torch.ops import flood; flood.build_all()" \
    || exit 1
fi
python3 tests/run_slots.py --jobs "$JOBS" --slots 4 --deadline "$DEADLINE" \
  --out "$OUT" --log-dir "$LOG" --at 50 100 200 1000 2000 5000 10000
NAMES=$(python3 -c "import json, sys
print(*(json.loads(l)['name'] for l in open(sys.argv[1]) if l.strip()))" "$JOBS")
best() {  # copy run $1's $2-best.msgpack into $OUT/best/$1 while under 60 MiB
  local d; d=$(ls -d "$LOG"/*/"$1" 2>/dev/null | head -1)
  [ -n "$d" ] && [ -e "$d/$2-best.msgpack" ] || return 0
  local used; used=$(du -sm "$OUT" | cut -f1)
  if [ "$used" -lt 60 ]; then
    mkdir -p "$OUT/best/$1"; cp "$d/$2-best.msgpack" "$OUT/best/$1/"
    ls "$d" | grep -- "all-best-" | sort -t- -k3 -n | tail -1 \
      | sed "s/^/$1 newest best: /"
  else echo "BEST $1/$2 LEFT OUT ($used MiB used)"; fi
}
for n in $NAMES; do best "$n" tracker; done
python3 tests/pack_states.py "$LOG" "$OUT" 60 $NAMES
for n in $NAMES; do best "$n" target; done
du -sm "$OUT"
