"""The port's analyzer (analysis/) against the JAX package's.

The lock, knob and error passes run on the same fixture snippets (the
shapes of the JAX package's own analyzer tests, copied here) in both
packages, each under its own package path, and must give the same
findings; the trace pass holds on torch-form snippets; the suppression
baseline round-trips through the port's CLI; ``analyze`` exits 0 on this
tree; the lock-order watchdog sees an inversion between two threads and
none in a run of the port's ``serve``.

Knob names in this file are built at run time (``_knob``), so that no
string in it is itself an undeclared ``MSBFS_*`` name for either
package's knob pass.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.analysis import (
    errors_pass as jerrors,
    knobs_pass as jknobs,
    locks as jlocks,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.analysis import (
    errors_pass,
    knobs_pass,
    lockwatch,
    locks,
    trace_lint,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.analysis.cli import (
    DEFAULT_BASELINE,
    analyze_main,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.analysis.core import (
    Finding,
    ParsedFile,
    diff_baseline,
    load_baseline,
    save_baseline,
)

from conftest import REPO_ROOT

JAX_PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu"
PORT = JAX_PKG + "_torch"


def _knob(suffix: str) -> str:
    return "MSBFS_" + suffix


def pf(path: str, src: str) -> ParsedFile:
    src = textwrap.dedent(src)
    return ParsedFile(path, path, ast.parse(src, filename=path), src)


def _norm(findings, pkg):
    """Findings without their package prefix and message, in order."""
    return sorted(
        (f.pass_name, f.rule, f.path.replace(pkg + "/", "<pkg>/"), f.line, f.symbol, f.detail)
        for f in findings
    )


# ---- the lock pass: (package-relative path, source).

LOCK_CASES = {
    "mixed_lock_write": ("serve/x.py", """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count = self.count + 1

            def sloppy(self):
                self.count = 0
    """),
    "init_writes_exempt": ("serve/x.py", """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count = self.count + 1
    """),
    "condition_aliases_lock": ("serve/x.py", """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self.count = 0

            def bump(self):
                with self._cv:
                    self.count += 1

            def reset(self):
                with self._lock:
                    self.count = 0
    """),
    "nested_with_cycle": ("runtime/x.py", """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def forward(self):
                with self._a:
                    with self._b:
                        pass

            def backward(self):
                with self._b:
                    with self._a:
                        pass
    """),
    "consistent_order": ("runtime/x.py", """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.RLock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    with self._b:
                        pass
    """),
    "cross_class_cycle": ("serve/x.py", """
        import threading

        class Alpha:
            def __init__(self):
                self._la = threading.Lock()

            def do_alpha(self):
                with self._la:
                    self.beta.do_beta()

        class Beta:
            def __init__(self):
                self._lb = threading.Lock()

            def do_beta(self):
                with self._lb:
                    pass

            def reverse(self):
                with self._lb:
                    self.alpha.do_alpha()
    """),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lock_pass_matches_jax(case):
    rel, src = LOCK_CASES[case]
    mine = locks.run([pf(f"{PORT}/{rel}", src)])
    theirs = jlocks.run([pf(f"{JAX_PKG}/{rel}", src)])
    assert _norm(mine, PORT) == _norm(theirs, JAX_PKG)
    assert bool(mine) == (case in ("mixed_lock_write", "nested_with_cycle", "cross_class_cycle"))
    report = locks.build_order_report([pf(f"{PORT}/{rel}", src)])
    assert report == jlocks.build_order_report([pf(f"{JAX_PKG}/{rel}", src)])


# ---- the knob pass: (path, source, registry names, README names); a
# "<pkg>/" path is inside the package, "<registry>" the registry file.
# Sources are formatted with the knob names X, NEVER, DOC and OK.

KNOB_CASES = {
    "raw_env_read": ("<pkg>/serve/x.py", 'import os\nv = os.environ.get("{X}")\n', ["X"], ["X"]),
    "getenv_read": ("<pkg>/serve/x.py", 'import os\nv = os.getenv("{X}")\n', ["X"], ["X"]),
    "env_write_and_accessor": (
        "<pkg>/serve/x.py",
        'import os\nfrom ..utils import knobs\nos.environ["{X}"] = "1"\nv = knobs.raw("{X}")\n',
        ["X"], ["X"],
    ),
    "subscript_load": ("<pkg>/serve/x.py", 'import os\nv = os.environ["{X}"]\n', ["X"], ["X"]),
    "read_outside_package": ("bench_x.py", 'import os\nv = os.environ.get("{X}")\n', ["X"], ["X"]),
    "unregistered": ("bench_x.py", 'NAME = "{X}"\n', [], []),
    "dead": ("bench_x.py", "x = 1\n", ["NEVER"], ["NEVER"]),
    "registry_self_reference": ("<registry>", '_k("{NEVER}")\n', ["NEVER"], ["NEVER"]),
    "undocumented": ("bench_x.py", 'v = "{DOC}"\n', ["DOC"], []),
    "clean": ("bench_x.py", 'v = "{OK}"\n', ["OK"], ["OK"]),
}


def _knob_names():
    return {k: _knob("FAKE_" + k) for k in ("X", "NEVER", "DOC", "OK")}


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_knob_pass_matches_jax(case, tmp_path):
    path, src, registered, documented = KNOB_CASES[case]
    names = _knob_names()
    src = src.format(**names)
    # Both READMEs name the knobs inside the port's section (the JAX
    # package reads the whole file, the port that section only).
    (tmp_path / "README.md").write_text(
        "# Title\n\n## PyTorch/CUDA port\n\nknobs: "
        + " ".join(f"`{names[n]}`" for n in documented) + "\n\n## Status\n"
    )
    registry = {names[n]: object() for n in registered}
    results = []
    for mod, pkg in ((knobs_pass, PORT), (jknobs, JAX_PKG)):
        where = mod.REGISTRY_FILE if path == "<registry>" else path.replace("<pkg>", pkg)
        found = mod.run([pf(where, src)], str(tmp_path), registry=registry)
        results.append(_norm(found, pkg))
    assert results[0] == results[1]
    assert bool(results[0]) == (case not in ("env_write_and_accessor", "read_outside_package",
                                             "clean"))


def test_knob_pass_reads_only_the_port_section(tmp_path):
    """A knob named in README.md outside the port's section is
    undocumented for the port."""
    name = _knob("FAKE_ELSEWHERE")
    (tmp_path / "README.md").write_text(
        f"## Usage\n`{name}`\n\n## PyTorch/CUDA port\nnothing\n\n## Status\n`{name}`\n"
    )
    out = knobs_pass.run([pf("bench_x.py", f'v = "{name}"\n')], str(tmp_path),
                         registry={name: object()})
    assert [(f.rule, f.detail) for f in out] == [("undocumented-knob", name)]


# ---- the error pass: (path, source, documented exit codes).

ERROR_CASES = {
    "runtime_error": ("<pkg>/serve/x.py", """
        def go():
            raise RuntimeError("boom")
    """, (0, 1)),
    "taxonomy_and_classifiable": ("<pkg>/serve/x.py", """
        class MsbfsError(Exception):
            exit_code = 6

        class InputError(MsbfsError):
            exit_code = 1

        def go(err):
            raise InputError("typed")

        def builtin():
            raise ValueError("classifiable")

        def reraise(err):
            raise

        def bound(err):
            raise err

        def classified(exc):
            raise classify(exc)
    """, (1, 6)),
    "local_runtime_subclass": ("<pkg>/serve/x.py", """
        class Oops(RuntimeError):
            pass

        def go():
            raise Oops("untyped transitively")
    """, (0, 1)),
    "exit_code_class": ("<pkg>/serve/x.py", """
        class WireError(Exception):
            exit_code = 1

        def go():
            raise WireError("typed by exit_code")
    """, (0, 1)),
    "faults_exempt": ("<pkg>/utils/faults.py", """
        def go():
            raise RuntimeError("simulated device failure")
    """, (0, 1)),
    "undocumented_exit": ("<pkg>/cli_x.py", """
        import sys

        def go():
            sys.exit(42)
    """, (0, 1)),
    "documented_exit": ("<pkg>/cli_x.py", """
        import sys

        def go():
            sys.exit(1)
    """, (0, 1)),
    "return_in_main": ("<pkg>/cli_x.py", """
        def main():
            return 42

        def helper():
            return 42
    """, (0, 1)),
    "negative_exit": ("<pkg>/cli_x.py", """
        import sys

        def go():
            sys.exit(-3)
    """, (0, 1)),
    "script_exit_code": ("chip_x.py", """
        import os

        class Step:
            exit_code = 77

        os._exit(5)
    """, (0, 1)),
    "tests_exempt": ("tests/x.py", "import sys\nsys.exit(99)\n", (0, 1)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_pass_matches_jax(case, tmp_path):
    path, src, codes = ERROR_CASES[case]
    docs = tmp_path / "docs"
    docs.mkdir()
    table = "\n".join(f"| {c} | `X` | meaning | recovery |" for c in codes)
    (docs / "RESILIENCE.md").write_text(f"| Exit | Class | M | R |\n|---|---|---|---|\n{table}\n")
    results = []
    for mod, pkg in ((errors_pass, PORT), (jerrors, JAX_PKG)):
        found = mod.run([pf(path.replace("<pkg>", pkg), src)], str(tmp_path))
        results.append(_norm(found, pkg))
    assert results[0] == results[1]
    fires = case in ("runtime_error", "local_runtime_subclass", "undocumented_exit",
                     "return_in_main", "negative_exit", "script_exit_code")
    assert bool(results[0]) == fires


# ---- the trace pass on torch's trace and capture entries.

TRACE_CASES = {
    "int_in_compiled": ("""
        import torch

        @torch.compile
        def step(x):
            return int(x)
    """, [("host-sync-in-trace", "step", "int()")]),
    "concrete_reads_exempt": ("""
        import torch

        @torch.compile(dynamic=False)
        def step(x):
            return int(x.shape[0]) + int(len(x)) + int(3)
    """, []),
    "untraced_free_to_sync": ("""
        def host_side(x):
            return int(x)
    """, []),
    "item_in_compiled_lambda": ("""
        import torch

        def drive(x):
            return torch.compile(lambda s: s.sum().item())(x)
    """, [("host-sync-in-trace", "drive", ".item()"),
          ("unrecorded-commit", "drive", "drive")]),
    "tolist_in_scripted_by_name": ("""
        import torch

        def body(x):
            return x.tolist()

        scripted = torch.jit.script(body)
    """, [("host-sync-in-trace", "body", ".tolist()"),
          ("unrecorded-commit", "body", "body")]),
    "np_asarray_in_traced": ("""
        import numpy as np
        import torch

        def body(x):
            return np.asarray(x)

        traced = torch.jit.trace(body, example_inputs=(0,))
    """, [("host-sync-in-trace", "body", "np.asarray")]),
    "time_in_partial_compile": ("""
        import time
        from functools import partial
        import torch

        @partial(torch.compile, fullgraph=True)
        def step(x):
            return x + time.time()
    """, [("impure-read-in-trace", "step", "time.time")]),
    "knob_in_nested_def": ("""
        import torch
        from ..utils import knobs

        @torch.compile
        def outer(x):
            def inner(y):
                return y * knobs.get_int("K", 1)
            return inner(x)
    """, [("impure-read-in-trace", "outer.inner", "knobs.get_int")]),
    "capture_syncs_and_reads": ("""
        import os
        import torch

        def record(g, x, stream):
            with torch.cuda.graph(g, stream=stream.synchronize()):
                y = x * 2
                torch.cuda.synchronize()
                z = os.environ["K"]
            return y
    """, [("host-sync-in-trace", "record", ".synchronize()"),
          ("impure-read-in-trace", "record", "os.environ[]"),
          ("unrecorded-commit", "record", "record")]),
    "impure_outside_trace_fine": ("""
        import time
        from ..utils import knobs

        def engine_init():
            return knobs.get_int("K", 1), time.time()
    """, []),
    "jax_jit_is_not_a_torch_entry": ("""
        import jax

        @jax.jit
        def step(x):
            return int(x)
    """, []),
    "unrecorded_commit": ("""
        def fetch(x):
            return x.cpu()
    """, [("unrecorded-commit", "fetch", "fetch")]),
    "recorded_commit_fine": ("""
        from ..utils.timing import record_dispatch

        def fetch(x):
            record_dispatch()
            return x.item()
    """, []),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_pass_on_torch_forms(case):
    src, want = TRACE_CASES[case]
    out = trace_lint.run([pf(f"{PORT}/ops/x.py", src)])
    assert sorted((f.rule, f.symbol, f.detail) for f in out) == sorted(want)


# ---- the baseline and the CLI.

VIOLATING = """
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1

    def sloppy(self):
        self.count = 0
"""

CLEAN = VIOLATING.replace("    def sloppy(self):\n        self.count = 0\n", "")


def test_fingerprint_and_diff_lifecycle(tmp_path):
    def finding(line=10, detail="X"):
        return Finding("knobs", "dead-knob", "utils/knobs.py", line, "KNOBS", detail, "msg")

    assert finding(line=10).fingerprint() == finding(line=99).fingerprint()
    path = str(tmp_path / "base.json")
    f1, f2 = finding(detail="A"), finding(detail="B")
    assert len(diff_baseline([f1, f2], load_baseline(path)).new) == 2
    save_baseline(path, [f1, f2])
    d = diff_baseline([f1], load_baseline(path))
    assert not d.new and len(d.suppressed) == 1 and [e["detail"] for e in d.stale] == ["B"]
    assert [f.detail for f in diff_baseline([f1, finding(detail="C")], load_baseline(path)).new] == ["C"]


def test_baseline_round_trip_through_the_cli(tmp_path, capsys):
    serve = tmp_path / PORT / "serve"
    serve.mkdir(parents=True)
    (serve / "toy.py").write_text(VIOLATING)
    args = ["--root", str(tmp_path), "--pass", "locks"]
    assert analyze_main(args) == 1
    assert analyze_main(args + ["--update-baseline"]) == 0
    baseline = tmp_path / DEFAULT_BASELINE
    assert DEFAULT_BASELINE == "ANALYSIS_BASELINE_TORCH.json" and baseline.exists()
    assert analyze_main(args) == 0
    capsys.readouterr()
    (serve / "toy.py").write_text(CLEAN)
    assert analyze_main(args + ["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True and not payload["new"] and not payload["suppressed"]
    assert len(payload["stale_suppressions"]) == 1
    assert analyze_main(["--pass", "bogus"]) == -1
    capsys.readouterr()


def test_analyze_exits_0_on_the_tree(capsys):
    """``python -m <port> analyze`` on this tree: every pass, no finding
    outside the port's own baseline, and JAX's baseline is not read."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli

    assert cli.main(["prog", "analyze", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["passes"] == ["trace", "locks", "knobs", "errors"]
    assert payload["ok"] and not payload["new"] and not payload["stale_suppressions"]
    scanned = {f["path"] for f in payload["suppressed"]}
    assert all(p.startswith((PORT + "/", "README.md")) for p in scanned), scanned
    base = load_baseline(os.path.join(REPO_ROOT, "ANALYSIS_BASELINE_TORCH.json"))
    assert len(base) == len(payload["suppressed"])


# ---- the lock-order watchdog.


def _watch_state():
    with lockwatch._state_lock:
        return dict(lockwatch._edges), list(lockwatch._inversions)


def _restore_state(snap):
    edges, inv = snap
    with lockwatch._state_lock:
        lockwatch._edges.clear()
        lockwatch._edges.update(edges)
        lockwatch._inversions[:] = inv


def test_watchdog_sees_a_two_thread_inversion():
    """Thread one takes A then B, thread two B then A: one inversion,
    naming both orders; the factories are restored at once."""
    if lockwatch._installed is not None:
        pytest.skip("the port's watchdog is installed by the caller")
    snap = _watch_state()
    real_lock = threading.Lock
    try:
        lockwatch.install()
        try:
            la = threading.Lock()
            lb = threading.Lock()
        finally:
            lockwatch.uninstall()
        assert threading.Lock is real_lock and isinstance(la, lockwatch._WatchedLock)
        before = len(lockwatch.inversions())

        def ordered(first, second):
            with first:
                with second:
                    pass

        for pair in ((la, lb), (lb, la)):
            t = threading.Thread(target=ordered, args=pair)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        inv = lockwatch.inversions()
        assert len(inv) == before + 1
        orders = {inv[-1]["first"], inv[-1]["second"]}
        assert orders == {f"{la._key} -> {lb._key}", f"{lb._key} -> {la._key}"}
        assert inv[-1]["thread"] != inv[-1]["other_thread"]
        assert "INVERSION" in lockwatch.report()
    finally:
        _restore_state(snap)


def test_watchdog_quiet_around_the_port_serve():
    """The port's serve smoke (a daemon, three queries, a reload) in a
    child process with ``MSBFS_LOCK_WATCHDOG=1`` installing the watchdog
    before the daemon exists: order edges seen, no inversion."""
    code = textwrap.dedent(f"""
        import json
        from {PORT}.analysis import lockwatch
        assert lockwatch.armed()
        lockwatch.install()
        from {PORT}.serve.smoke import run_smoke
        rc = run_smoke(device="cpu")
        lockwatch.uninstall()
        print(json.dumps(dict(rc=rc, edges=lockwatch.edge_count(),
                              inversions=lockwatch.inversions())))
    """)
    env = dict(os.environ, MSBFS_LOCK_WATCHDOG="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["rc"] == 0
    assert result["edges"] > 0
    assert result["inversions"] == []
