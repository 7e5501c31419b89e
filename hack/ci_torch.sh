#!/usr/bin/env bash
# The PyTorch/CUDA port's CI gate: `make ci-torch`. The twin of hack/ci.sh,
# step for step, over kube_throttler_tpu_torch: its analyzer (12 checkers +
# the stale-waiver gate) first, then the smoke tier that proves the
# analyzer, the lock assassin, the lockset race detector and the epoch
# assassin work (planted races and stale verdicts must fire), the columnar
# store's memory bounds, the hunt's lifecycle and the rolling-upgrade smoke.
# Every step that runs a device data plane runs it with --device cpu, so
# the gate needs no card; the full tier-1 suite stays `make test`.
#
#   hack/ci_torch.sh          run the gate
#   hack/ci_torch.sh --list   print every step's command, run nothing
#   hack/ci_torch.sh --help   print this text
set -euo pipefail
cd "$(dirname "$0")/.."
PY="${PY:-python}"

LIST=0
case "${1:-}" in
    "") ;;
    --list) LIST=1 ;;
    --help|-h) sed -n '2,/^set -e/{/^set -e/d;s/^# \{0,1\}//;p}' "$0"; exit 0 ;;
    *) echo "usage: $0 [--list | --help]" >&2; exit 2 ;;
esac

# print a step's command, and run it unless listing
run() {
    echo "+ $*"
    if [ "$LIST" = 0 ]; then "$@"; fi
}

echo "== lint: compileall + 12-checker static analysis + stale-waiver gate =="
run make lint-torch PY="$PY"

echo "== smoke: analyzer fixtures, lock assassin + hold budgets, journal =="
run "$PY" -m pytest \
    tests/test_torch_analysis_checkers.py tests/test_torch_lockorder.py tests/test_torch_journal.py \
    -q -p no:cacheprovider

echo "== race: lockset detector must-fire gate + armed concurrency smoke =="
run make race-test-torch PY="$PY"

echo "== memory: 50k-pod columnar-arena build vs committed per-pod bounds =="
run "$PY" tools/memsmoke_torch.py --device cpu

echo "== hunt: planted-bug find -> confirm -> shrink -> promote + coverage artifact =="
# the planted mock.status.delay regression must be found, shrunk and
# promoted; promotion goes to a scratch dir (the committed corpus is
# maintained in-tree), and the coverage report is the archivable artifact
HUNT_DIR="${KT_CI_ARTIFACTS:-build/ci-torch}/hunt"
if [ "$LIST" = 0 ]; then rm -rf "$HUNT_DIR" && mkdir -p "$HUNT_DIR"; fi
run "$PY" -m kube_throttler_tpu_torch.scenarios.hunt smoke --device cpu \
    --workdir "$HUNT_DIR" --report "$HUNT_DIR/hunt-coverage.json" \
    --promote-dir "$HUNT_DIR/promoted"
echo "hunt coverage artifact: $HUNT_DIR/hunt-coverage.json"

echo "== upgrade: reduced-scale rolling-upgrade smoke (live TCP fleet roll) =="
# one worker-first roll with a mid-roll SIGKILL plus the clean
# incompatible-major refusal, at smoke scale
run "$PY" tools/upgradetest_torch.py smoke

if [ "$LIST" = 0 ]; then echo "ci-torch gate: OK"; fi
