"""Shared analysis plumbing: findings, fingerprints, the suppression
baseline, file discovery, and the human-readable table (the JAX
package's analysis/core.py).

A finding's fingerprint deliberately excludes the line number — the
baseline must survive unrelated edits above a suppressed site — and
hashes (pass, rule, path, symbol, detail) instead.  ``symbol`` is the
enclosing function/class and ``detail`` the stable payload (attribute
name, knob name, exception class), so two distinct violations in one
function still get distinct prints.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# The package the passes scan (the port's), by its repo-relative path.
PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"


@dataclass
class Finding:
    pass_name: str  # trace / locks / knobs / errors
    rule: str  # short rule id, e.g. host-sync-in-trace
    path: str  # repo-relative, forward slashes
    line: int
    symbol: str  # enclosing def/class ("" at module level)
    detail: str  # stable payload: knob name, attr, call text
    message: str  # human sentence

    def fingerprint(self) -> str:
        key = "|".join((self.pass_name, self.rule, self.path, self.symbol, self.detail))
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def as_dict(self) -> Dict[str, object]:
        return {
            "pass": self.pass_name,
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "detail": self.detail,
            "message": self.message,
            "fingerprint": self.fingerprint(),
        }


@dataclass
class ParsedFile:
    path: str  # repo-relative
    abspath: str
    tree: ast.AST
    source: str


def discover(root: str, rel_dirs: Sequence[str]) -> List[ParsedFile]:
    """Parse every .py file under the given repo-relative dirs (or
    repo-relative single files).  Unparseable files raise — a syntax
    error in the tree is itself a finding-worthy failure."""
    out: List[ParsedFile] = []
    for rel in rel_dirs:
        base = os.path.join(root, rel)
        if os.path.isfile(base):
            paths = [base]
        else:
            paths = []
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        paths.append(os.path.join(dirpath, fn))
        for p in sorted(paths):
            with open(p, "r") as fh:
                src = fh.read()
            relpath = os.path.relpath(p, root).replace(os.sep, "/")
            out.append(ParsedFile(relpath, p, ast.parse(src, filename=relpath), src))
    return out


# --- suppression baseline -------------------------------------------------

@dataclass
class BaselineDiff:
    new: List[Finding] = field(default_factory=list)  # not in baseline -> fatal
    suppressed: List[Finding] = field(default_factory=list)  # matched baseline
    stale: List[Dict[str, object]] = field(default_factory=list)  # baseline entries no finding matched


def load_baseline(path: str) -> List[Dict[str, object]]:
    if not os.path.exists(path):
        return []
    with open(path, "r") as fh:
        data = json.load(fh)
    return list(data.get("suppressions", []))


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    entries = [
        {
            "fingerprint": f.fingerprint(),
            "pass": f.pass_name,
            "rule": f.rule,
            "path": f.path,
            "symbol": f.symbol,
            "detail": f.detail,
            "message": f.message,
        }
        for f in sorted(findings, key=lambda f: (f.pass_name, f.path, f.line))
    ]
    with open(path, "w") as fh:
        json.dump({"suppressions": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def diff_baseline(findings: Sequence[Finding], baseline: Sequence[Dict[str, object]]) -> BaselineDiff:
    by_fp: Dict[str, Dict[str, object]] = {str(e["fingerprint"]): dict(e) for e in baseline}
    seen = set()
    out = BaselineDiff()
    for f in findings:
        fp = f.fingerprint()
        if fp in by_fp:
            seen.add(fp)
            out.suppressed.append(f)
        else:
            out.new.append(f)
    out.stale = [e for fp, e in sorted(by_fp.items()) if fp not in seen]
    return out


# --- rendering ------------------------------------------------------------

def render_table(findings: Sequence[Finding]) -> str:
    if not findings:
        return "(none)"
    rows = [("PASS", "RULE", "WHERE", "DETAIL")]
    for f in sorted(findings, key=lambda f: (f.pass_name, f.path, f.line)):
        where = f"{f.path}:{f.line}"
        if f.symbol:
            where += f" ({f.symbol})"
        rows.append((f.pass_name, f.rule, where, f.message))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = []
    for r in rows:
        lines.append(
            f"{r[0]:<{widths[0]}}  {r[1]:<{widths[1]}}  {r[2]:<{widths[2]}}  {r[3]}"
        )
    return "\n".join(lines)


# --- small AST helpers shared by the passes -------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def enclosing_symbols(tree: ast.AST) -> Dict[ast.AST, str]:
    """Map every node to its enclosing def/class chain ('Cls.meth')."""
    out: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, stack: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            cstack = stack
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                cstack = stack + (child.name,)
            out[child] = ".".join(cstack)
            walk(child, cstack)

    out[tree] = ""
    walk(tree, ())
    return out
