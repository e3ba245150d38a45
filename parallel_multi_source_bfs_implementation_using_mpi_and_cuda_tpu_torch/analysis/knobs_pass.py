"""Knob-contract pass: the port's ``MSBFS_*`` env surface must round-trip
through its ``utils/knobs.py`` and the knob table of README.md's port
section exactly (the JAX package's analysis/knobs_pass.py, over the
port's files and registry).

Rules:

* ``unregistered-knob`` — a ``MSBFS_*`` string literal anywhere in the
  scanned tree that is not a registry name.
* ``raw-env-read`` — package code (outside ``utils/knobs.py``) reading a
  knob straight off ``os.environ``/``os.getenv`` instead of through the
  registry accessors.  Env *writes* (harness setup, subprocess plumbing)
  stay legal.
* ``dead-knob`` — a registered knob nothing references.  References are
  counted across .py files plus the package's native sources
  (``*.cpp``, ``*.cu``), since ``MSBFS_NATIVE_THREADS`` is read in C++.
* ``undocumented-knob`` — a registered knob missing from the port
  section of README.md (from its ``## PyTorch/CUDA port`` heading to the
  next ``## `` heading).

The analyzer's own fixture corpus (``tests/test_torch_analyze.py``) is
excluded from the literal scan: it deliberately contains violating
snippets.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Set

from .core import PKG, Finding, ParsedFile, dotted

KNOB_RE = re.compile(r"^MSBFS_[A-Z0-9_]+$")
KNOB_TOKEN_RE = re.compile(r"MSBFS_[A-Z0-9_]+")
EXCLUDED_FILES = {"tests/test_torch_analyze.py"}
REGISTRY_FILE = f"{PKG}/utils/knobs.py"
README_SECTION = "## PyTorch/CUDA port"


def _load_registry() -> Dict[str, object]:
    from ..utils import knobs as _knobs

    return dict(_knobs.KNOBS)


def readme_section(root: str) -> str:
    """README.md's port section, or "" when the file or the section is
    missing."""
    path = os.path.join(root, "README.md")
    if not os.path.exists(path):
        return ""
    with open(path, "r") as fh:
        text = fh.read()
    start = text.find(README_SECTION)
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(README_SECTION))
    return text[start:] if end < 0 else text[start:end]


def _is_env_read(node: ast.Call) -> bool:
    name = dotted(node.func) or ""
    return name in ("os.environ.get", "os.getenv", "environ.get", "getenv")


def run(files: List[ParsedFile], root: str, registry: Dict[str, object] = None) -> List[Finding]:
    registry = registry if registry is not None else _load_registry()
    findings: List[Finding] = []
    referenced: Set[str] = set()

    for pf in files:
        if pf.path in EXCLUDED_FILES:
            continue
        in_registry_file = pf.path == REGISTRY_FILE
        in_package = pf.path.startswith(f"{PKG}/")
        if in_package and not in_registry_file:
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.Call) and _is_env_read(node):
                    args = list(node.args)
                    if args and isinstance(args[0], ast.Constant) and isinstance(args[0].value, str):
                        if KNOB_RE.match(args[0].value):
                            findings.append(Finding(
                                "knobs", "raw-env-read", pf.path, node.lineno, "",
                                args[0].value,
                                f"{args[0].value} read via os.environ — go through utils.knobs",
                            ))
                elif (
                    isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and (dotted(node.value) or "") in ("os.environ", "environ")
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and KNOB_RE.match(node.slice.value)
                ):
                    findings.append(Finding(
                        "knobs", "raw-env-read", pf.path, node.lineno, "",
                        node.slice.value,
                        f"{node.slice.value} read via os.environ[] — go through utils.knobs",
                    ))

        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for tok in KNOB_TOKEN_RE.findall(node.value):
                    if not in_registry_file:
                        # Registry declarations don't count as references,
                        # or dead-knob could never fire.
                        referenced.add(tok)
                    if (
                        KNOB_RE.match(node.value)
                        and tok not in registry
                        and not in_registry_file
                    ):
                        findings.append(Finding(
                            "knobs", "unregistered-knob", pf.path, node.lineno, "",
                            tok,
                            f"{tok} is not declared in utils/knobs.py",
                        ))

    # Native sources count as references (MSBFS_NATIVE_THREADS lives in C++).
    for pattern in ("*.cpp", "*.cu"):
        for src in glob.glob(os.path.join(root, PKG, "**", pattern), recursive=True):
            with open(src, "r", errors="replace") as fh:
                referenced.update(KNOB_TOKEN_RE.findall(fh.read()))

    reg_names = set(registry)
    for name in sorted(reg_names):
        if name not in referenced:
            findings.append(Finding(
                "knobs", "dead-knob", REGISTRY_FILE, 1, "KNOBS", name,
                f"{name} is registered but nothing reads it — delete it",
            ))

    documented = set(KNOB_TOKEN_RE.findall(readme_section(root)))
    for name in sorted(reg_names):
        if name not in documented:
            findings.append(Finding(
                "knobs", "undocumented-knob", "README.md", 1, "knob-table", name,
                f"{name} is registered but missing from the port section's knob table",
            ))
    return findings
