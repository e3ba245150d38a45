"""Trace-safety lint for the port's ``ops/`` and ``parallel/``: the JAX
package's three rules (analysis/trace_lint.py) on their torch
counterparts.

Code runs under a trace or a capture when it is a function decorated
with ``torch.compile``/``torch.jit.script``/``torch.jit.trace`` (directly
or via ``partial``), a function passed by name or as a lambda into one of
those as a call, a function defined inside such a function, or the body
of a ``with torch.cuda.graph(...)`` block (recorded once, replayed
without its host code):

* ``host-sync-in-trace`` — ``int()``/``bool()``/``float()`` on a value
  that is not provably concrete (shape/len/ndim/constant arguments are
  exempt), ``.item()``, ``.tolist()``, ``.cpu()``, ``np.asarray``/
  ``np.array`` and ``synchronize()`` (``torch.cuda.synchronize``, an
  event's or a stream's) all wait for the device: a graph break under
  ``torch.compile``, an error under capture.
* ``impure-read-in-trace`` — ``time.*``, ``random.*``/``np.random.*``,
  ``os.environ``/``os.getenv`` and ``knobs.*`` reads are frozen at trace
  or capture time and silently stop varying on replay.
* ``unrecorded-commit`` — a function that blocks on device results
  (``.item()``, ``.tolist()``, ``.cpu()`` or a ``synchronize()``) without
  calling ``utils.timing.record_dispatch`` breaks the one count per host
  sync that the ``dispatch_count`` line reports.

Resolution is per-module and single-level by design: a helper called
*from* a traced function is not followed.  That keeps the pass O(tree)
and its findings local enough to act on.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from .core import Finding, ParsedFile, dotted, enclosing_symbols

TRACE_ENTRY_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace", "jit.script", "jit.trace",
}
TRACE_DECORATORS = TRACE_ENTRY_CALLS | {"compile"}
CAPTURE_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
CONCRETE_MARKERS = {"shape", "ndim", "len", "range", "size"}
IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.")
IMPURE_EXACT = {"os.getenv", "os.environ.get"}
KNOB_READS = {"knobs.raw", "knobs.get_int", "knobs.get_float", "knobs.get_str"}
SYNC_METHODS = {"item", "tolist", "cpu", "synchronize"}
RECORDERS = {"record_dispatch"}


def _is_concrete_arg(node: ast.AST) -> bool:
    """True when the argument of int()/bool()/float() is provably a host
    value: a constant, or any expression mentioning .shape/.ndim/len()."""
    if isinstance(node, ast.Constant):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in CONCRETE_MARKERS:
            return True
        if isinstance(sub, ast.Call):
            name = dotted(sub.func)
            if name in ("len", "range"):
                return True
    return False


def _decorated_traced(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted(target) or ""
        if name in TRACE_DECORATORS:
            return True
        # functools.partial(torch.compile, ...)
        if isinstance(dec, ast.Call) and name.rsplit(".", 1)[-1] == "partial" and dec.args:
            if (dotted(dec.args[0]) or "") in TRACE_DECORATORS:
                return True
    return False


def _collect_traced(tree: ast.AST) -> Set[ast.AST]:
    """All function/lambda nodes whose bodies run under a trace, and the
    ``with`` nodes whose bodies run under a CUDA graph capture."""
    defs_by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)

    traced: Set[ast.AST] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _decorated_traced(node):
            traced.add(node)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and (dotted(ctx.func) or "") in CAPTURE_CONTEXTS:
                    traced.add(node)
        if isinstance(node, ast.Call):
            if (dotted(node.func) or "") not in TRACE_ENTRY_CALLS:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    traced.add(arg)
                elif isinstance(arg, ast.Name):
                    for d in defs_by_name.get(arg.id, []):
                        traced.add(d)

    # Functions defined inside a traced function execute at trace time.
    grew = True
    while grew:
        grew = False
        for t in list(traced):
            for sub in ast.walk(t):
                if sub is not t and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ) and sub not in traced:
                    traced.add(sub)
                    grew = True
    return traced


def _scan_traced_body(pf: ParsedFile, fn: ast.AST, symbol: str, findings: List[Finding]) -> None:
    own_nested = {
        sub for sub in ast.walk(fn)
        if sub is not fn
        and isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
    }
    # A capture block's context expression runs before the capture.
    roots = fn.body if isinstance(fn, (ast.With, ast.AsyncWith)) else [fn]

    def nodes():
        # Walk the body but attribute nested-def findings to the nested
        # def's own scan (they are traced too); avoid double reports.
        for root in roots:
            for sub in ast.walk(root):
                if any(sub is n or _contains(n, sub) for n in own_nested):
                    continue
                yield sub

    for sub in nodes():
        if isinstance(sub, ast.Call):
            name = dotted(sub.func) or ""
            leaf = _method(sub)
            if name in ("int", "bool", "float") and sub.args and not _is_concrete_arg(sub.args[0]):
                findings.append(Finding(
                    "trace", "host-sync-in-trace", pf.path, sub.lineno, symbol,
                    f"{name}()",
                    f"{name}() on a possibly-device value forces a host sync inside a traced function",
                ))
            elif leaf in SYNC_METHODS:
                findings.append(Finding(
                    "trace", "host-sync-in-trace", pf.path, sub.lineno, symbol,
                    f".{leaf}()", f".{leaf}() forces a host sync inside a traced function",
                ))
            elif name in ("np.asarray", "np.array", "numpy.asarray", "numpy.array"):
                findings.append(Finding(
                    "trace", "host-sync-in-trace", pf.path, sub.lineno, symbol,
                    name, f"{name} materialises a device value on host inside a traced function",
                ))
            elif name.startswith(IMPURE_PREFIXES) or name in IMPURE_EXACT or name in KNOB_READS:
                findings.append(Finding(
                    "trace", "impure-read-in-trace", pf.path, sub.lineno, symbol,
                    name, f"{name} is frozen at trace time inside a traced function",
                ))
        elif isinstance(sub, ast.Subscript):
            if (dotted(sub.value) or "") == "os.environ":
                findings.append(Finding(
                    "trace", "impure-read-in-trace", pf.path, sub.lineno, symbol,
                    "os.environ[]", "os.environ read is frozen at trace time inside a traced function",
                ))


def _method(call: ast.Call) -> str:
    """The attribute a call invokes (``item`` of ``x.sum().item()``), or
    "" for a call of a plain name."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


def _contains(parent: ast.AST, node: ast.AST) -> bool:
    return any(sub is node for sub in ast.walk(parent))


def _scan_commits(pf: ParsedFile, symbols: Dict[ast.AST, str], findings: List[Finding]) -> None:
    for node in ast.walk(pf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        blocking: List[ast.Call] = []
        records = False
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and sub is not node:
                continue
            if isinstance(sub, ast.Call):
                if _method(sub) in SYNC_METHODS:
                    blocking.append(sub)
                if (dotted(sub.func) or "").rsplit(".", 1)[-1] in RECORDERS:
                    records = True
        if blocking and not records:
            first = blocking[0]
            findings.append(Finding(
                "trace", "unrecorded-commit", pf.path, first.lineno,
                symbols.get(node, node.name), node.name,
                f"{node.name} blocks on device results without record_dispatch "
                "(one count per host sync)",
            ))


def run(files: List[ParsedFile]) -> List[Finding]:
    findings: List[Finding] = []
    for pf in files:
        symbols = enclosing_symbols(pf.tree)
        traced = _collect_traced(pf.tree)
        for fn in traced:
            sym = symbols.get(fn, "")
            name = getattr(fn, "name", "<lambda>")
            label = sym if sym.endswith(name) or name == "<lambda>" else (sym or name)
            _scan_traced_body(pf, fn, label or name, findings)
        _scan_commits(pf, symbols, findings)
    return findings
