"""``python -m <port> analyze`` — run the static passes over the files
the port owns, diff against the port's suppression baseline, exit 0
clean / 1 on new findings (the JAX package's ``analyze``).

Usage:
    python -m parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch analyze
        [--json] [--pass trace|locks|knobs|errors]...
        [--baseline PATH] [--update-baseline] [--root DIR]

The scan set: the port's package (``ops/`` and ``parallel/`` for the
trace pass, ``serve/`` and ``runtime/`` for the lock pass, all of it
for the knob and error passes, with ``tests/test_torch_*.py``,
``chip_smoke.py``, ``chip_compare.py`` and ``chip_probe_*.py``).  The
baseline (ANALYSIS_BASELINE_TORCH.json at the repo root; the JAX
package's ANALYSIS_BASELINE.json is its own) holds fingerprints of
accepted pre-existing debt: matched findings are reported but not
fatal, unmatched ones exit 1, and baseline entries nothing matched are
listed as stale so the file shrinks as debt is paid.
``--update-baseline`` rewrites it from the current findings.

This module imports neither torch nor the engine stack.
"""

from __future__ import annotations

import fnmatch
import json
import os
import sys
from typing import Dict, List

from . import errors_pass, knobs_pass, locks, trace_lint
from .core import (
    PKG,
    Finding,
    diff_baseline,
    discover,
    load_baseline,
    render_table,
    save_baseline,
)

PASSES = ("trace", "locks", "knobs", "errors")
DEFAULT_BASELINE = "ANALYSIS_BASELINE_TORCH.json"
# Files of the port outside its package, relative to the root.
PORT_FILES = ("tests/test_torch_*.py", "chip_smoke.py", "chip_compare.py", "chip_probe_*.py")


def _default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _port_files(root: str) -> List[str]:
    out = []
    for pattern in PORT_FILES:
        folder, name = os.path.split(pattern)
        base = os.path.join(root, folder)
        if os.path.isdir(base):
            out.extend(
                os.path.join(folder, fn) if folder else fn
                for fn in sorted(os.listdir(base))
                if fnmatch.fnmatch(fn, name)
            )
    return out


def run_passes(root: str, which: List[str]) -> Dict[str, object]:
    findings: List[Finding] = []
    lock_report: Dict[str, object] = {}

    if "trace" in which:
        files = discover(root, [f"{PKG}/ops", f"{PKG}/parallel"])
        findings.extend(trace_lint.run(files))
    if "locks" in which:
        files = discover(root, [f"{PKG}/serve", f"{PKG}/runtime"])
        findings.extend(locks.run(files))
        lock_report = locks.build_order_report(files)
    if "knobs" in which or "errors" in which:
        dirs = [d for d in [PKG] if os.path.exists(os.path.join(root, d))]
        files = discover(root, dirs + _port_files(root))
        if "knobs" in which:
            findings.extend(knobs_pass.run(files, root))
        if "errors" in which:
            findings.extend(errors_pass.run(files, root))
    return {"findings": findings, "lock_report": lock_report}


def analyze_main(argv: List[str]) -> int:
    as_json = False
    update = False
    which: List[str] = []
    baseline_path = None
    root = _default_root()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--json":
            as_json = True
        elif arg == "--update-baseline":
            update = True
        elif arg == "--pass":
            i += 1
            if i >= len(argv) or argv[i] not in PASSES:
                print(f"--pass must be one of {'/'.join(PASSES)}", file=sys.stderr)
                return -1
            which.append(argv[i])
        elif arg == "--baseline":
            i += 1
            if i >= len(argv):
                print("--baseline needs a path", file=sys.stderr)
                return -1
            baseline_path = argv[i]
        elif arg == "--root":
            i += 1
            if i >= len(argv):
                print("--root needs a directory", file=sys.stderr)
                return -1
            root = argv[i]
        else:
            print(f"unknown argument {arg!r}", file=sys.stderr)
            return -1
        i += 1
    if not which:
        which = list(PASSES)
    if baseline_path is None:
        baseline_path = os.path.join(root, DEFAULT_BASELINE)

    result = run_passes(root, which)
    findings: List[Finding] = result["findings"]

    if update:
        save_baseline(baseline_path, findings)
        print(f"baseline rewritten: {len(findings)} suppression(s) -> {baseline_path}")
        return 0

    diff = diff_baseline(findings, load_baseline(baseline_path))

    if as_json:
        payload = {
            "passes": which,
            "new": [f.as_dict() for f in diff.new],
            "suppressed": [f.as_dict() for f in diff.suppressed],
            "stale_suppressions": diff.stale,
            "lock_report": result["lock_report"],
            "ok": not diff.new,
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(f"msbfs analyze: passes={','.join(which)}  "
              f"findings={len(findings)}  new={len(diff.new)}  "
              f"suppressed={len(diff.suppressed)}  stale={len(diff.stale)}")
        if diff.new:
            print("\nNEW findings (fix or add to the baseline):")
            print(render_table(diff.new))
        if diff.suppressed:
            print("\nsuppressed by baseline:")
            print(render_table(diff.suppressed))
        if diff.stale:
            print("\nstale baseline entries (debt paid — prune with --update-baseline):")
            for e in diff.stale:
                print(f"  {e.get('pass')}/{e.get('rule')}: {e.get('detail')} @ {e.get('path')}")
    return 1 if diff.new else 0


if __name__ == "__main__":
    sys.exit(analyze_main(sys.argv[1:]))
