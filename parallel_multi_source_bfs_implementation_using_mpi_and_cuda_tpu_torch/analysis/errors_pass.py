"""Error-contract pass: the port's raises stay inside the typed taxonomy
and its exit codes inside the docs/RESILIENCE.md table, which the port
keeps (the JAX package's analysis/errors_pass.py, over the port's files).

* ``untyped-raise`` — a ``raise`` of ``RuntimeError``/``Exception`` (or
  a class that only reaches those) in package code.  Allowed: the
  ``MsbfsError`` taxonomy (runtime/supervisor.py), any class declaring
  an ``exit_code`` (wire-mirrored taxonomy like ``ServerError``), the
  builtins ``classify()`` knows how to map (ValueError, OSError,
  TimeoutError, MemoryError, ...), bare re-raises, raising a bound
  variable, and ``raise classify(...)``.  ``utils/faults.py`` is exempt
  by design — its ``Simulated*`` classes subclass RuntimeError exactly
  because they imitate raw device failures.
* ``undocumented-exit-code`` — an integer exit-code literal
  (``sys.exit``/``os._exit``/``SystemExit``/``exit_code = N``) missing
  from the RESILIENCE.md exit-code table.

Class bases resolve by leaf name across all scanned files, so the
taxonomy is discovered, not hard-coded.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set

from .core import PKG, Finding, ParsedFile, dotted, enclosing_symbols

TAXONOMY_ROOT = "MsbfsError"
EXEMPT_FILES = (f"{PKG}/utils/faults.py",)
# Builtins runtime.supervisor.classify() maps onto the taxonomy.
CLASSIFIABLE_BUILTINS = {
    "ValueError", "TypeError", "KeyError", "IndexError", "AttributeError",
    "OSError", "IOError", "FileNotFoundError", "NotADirectoryError",
    "PermissionError", "ConnectionError", "BrokenPipeError",
    "ConnectionResetError", "ConnectionRefusedError", "InterruptedError",
    "NotImplementedError", "MemoryError", "TimeoutError", "StopIteration",
    "ImportError", "ModuleNotFoundError",
}
FORBIDDEN_BUILTINS = {"RuntimeError", "Exception", "BaseException", "ArithmeticError"}
EXIT_TABLE_RE = re.compile(r"^\|\s*`?(-?\d+)`?\s*\|", re.MULTILINE)


def _class_graph(files: List[ParsedFile]) -> Dict[str, Set[str]]:
    """leaf class name -> set of leaf base names (package-wide)."""
    out: Dict[str, Set[str]] = {}
    for pf in files:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                bases = set()
                for b in node.bases:
                    name = dotted(b)
                    if name:
                        bases.add(name.rsplit(".", 1)[-1])
                out.setdefault(node.name, set()).update(bases)
    return out


def _declares_exit_code(files: List[ParsedFile]) -> Set[str]:
    """Classes that carry an ``exit_code`` (class attr or self-assign):
    the wire-mirrored arm of the taxonomy."""
    out: Set[str] = set()
    for pf in files:
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name) and tgt.id == "exit_code":
                            out.add(node.name)
                        elif (
                            isinstance(tgt, ast.Attribute)
                            and tgt.attr == "exit_code"
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            out.add(node.name)
    return out


def _allowed_classes(files: List[ParsedFile]) -> Set[str]:
    graph = _class_graph(files)
    allowed = set(CLASSIFIABLE_BUILTINS) | {TAXONOMY_ROOT} | _declares_exit_code(files)
    changed = True
    while changed:
        changed = False
        for cls, bases in graph.items():
            if cls not in allowed and bases & allowed:
                allowed.add(cls)
                changed = True
    return allowed


def _raised_class(node: ast.Raise) -> Optional[str]:
    exc = node.exc
    if exc is None:
        return None  # bare re-raise
    if isinstance(exc, ast.Call):
        name = dotted(exc.func)
    else:
        name = dotted(exc)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    # raise classify(err) / raise err (lowercase binding) are fine.
    if leaf == "classify" or (leaf and not leaf[0].isupper()):
        return None
    return leaf


def run(files: List[ParsedFile], root: str) -> List[Finding]:
    findings: List[Finding] = []
    allowed = _allowed_classes(files)
    known_classes = set(_class_graph(files))

    for pf in files:
        if pf.path in EXEMPT_FILES or not pf.path.startswith(f"{PKG}/"):
            continue
        symbols = enclosing_symbols(pf.tree)
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Raise):
                continue
            leaf = _raised_class(node)
            if leaf is None or leaf == "SystemExit":
                continue
            bad_builtin = leaf in FORBIDDEN_BUILTINS
            bad_local = leaf in known_classes and leaf not in allowed
            if bad_builtin or bad_local:
                findings.append(Finding(
                    "errors", "untyped-raise", pf.path, node.lineno,
                    symbols.get(node, ""), leaf,
                    f"raise {leaf} is outside the typed taxonomy "
                    "(subclass MsbfsError or a classifiable builtin)",
                ))

    documented = _documented_exit_codes(root)
    for pf in files:
        if pf.path.startswith(("tests/", "benchmarks/")):
            continue  # harness code exits with whatever pytest needs
        for line, code, ctx in _exit_code_literals(pf):
            if code not in documented:
                findings.append(Finding(
                    "errors", "undocumented-exit-code", pf.path, line, ctx,
                    str(code),
                    f"exit code {code} is not in the docs/RESILIENCE.md table",
                ))
    return findings


def _documented_exit_codes(root: str) -> Set[int]:
    path = os.path.join(root, "docs", "RESILIENCE.md")
    if not os.path.exists(path):
        return set()
    with open(path, "r") as fh:
        text = fh.read()
    return {int(m) for m in EXIT_TABLE_RE.findall(text)}


def _int_literal(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) and not isinstance(
        node.value, bool
    ):
        return int(node.value)
    if (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, ast.USub)
        and isinstance(node.operand, ast.Constant)
        and isinstance(node.operand.value, int)
    ):
        return -int(node.operand.value)
    return None


def _exit_code_literals(pf: ParsedFile):
    symbols = enclosing_symbols(pf.tree)
    # return <int> inside a main()/*_main() is an exit code too: the
    # CLI entry points are sys.exit(main()) wrappers.
    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node.name == "main" or node.name.endswith("_main")
        ):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    code = _int_literal(sub.value)
                    if code is not None:
                        yield sub.lineno, code, symbols.get(node, node.name)
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            if name in ("sys.exit", "os._exit", "SystemExit", "exit") and node.args:
                code = _int_literal(node.args[0])
                if code is not None:
                    yield node.lineno, code, symbols.get(node, "")
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                is_attr = (
                    isinstance(tgt, ast.Attribute)
                    and tgt.attr == "exit_code"
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                )
                is_name = isinstance(tgt, ast.Name) and tgt.id == "exit_code"
                if (is_attr or is_name) and isinstance(node.value, ast.Constant) and isinstance(
                    node.value.value, int
                ):
                    yield node.lineno, int(node.value.value), symbols.get(node, "")
