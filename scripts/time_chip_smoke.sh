#!/bin/bash
# Wall time of chip_smoke.py by phase, for checkouts run one after the
# other on the same card (e.g. a parent unpacked with `git archive` and this
# tree): each phase header and the last line stamped with the seconds since
# the run began.
#
#   bash scripts/time_chip_smoke.sh build/parent .
#
# Prints each checkout's stamped headers and chip_smoke.py's own exit code;
# exits non-zero if any checkout's run failed.  Needs a card.
set -o pipefail
stamp() {
  python3 -c "import sys, time
t0 = time.time()
for line in sys.stdin:
    sys.stdout.write(f'{time.time() - t0:8.1f} {line}')
    sys.stdout.flush()"
}
status=0
for dir in "$@"; do
  (cd "$dir" && python3 -u chip_smoke.py 2>/dev/null | stamp \
     | grep -E '^ *[0-9.]+ (== |\{"ok")'; exit "${PIPESTATUS[0]}")
  rc=$?
  echo "$dir: exit $rc"
  [ "$rc" -eq 0 ] || status=1
done
exit "$status"
