#!/bin/bash
# Run the test suite one file per pytest process.
#
# Why: jaxlib's CPU backend can segfault/abort the *process* on the
# largest fresh engine-program compiles.  In a single pytest process that kills the
# whole run; per-file processes bound the blast radius to one file, and a
# crashed file re-run alone passes.  Functionally identical coverage to
# `python -m pytest tests/ -q`.
set -u
cd "$(dirname "$0")/.."
fail=0
for f in tests/test_*.py; do
  echo "=== $f"
  python -m pytest "$f" -q --no-header 2>&1 | tail -2
  rc=${PIPESTATUS[0]}
  if [ "$rc" -ne 0 ]; then
    echo "=== $f FAILED (rc=$rc), retrying once in a fresh process"
    python -m pytest "$f" -q --no-header 2>&1 | tail -2
    rc=${PIPESTATUS[0]}
    [ "$rc" -ne 0 ] && fail=1
  fi
done
exit $fail
