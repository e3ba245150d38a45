"""Static lock-discipline analysis for the port's ``serve/`` and
``runtime/`` (the JAX package's analysis/locks.py).

Two rules per the lock contract (docs/ANALYSIS.md):

* ``mixed-lock-write`` — an instance attribute assigned both inside and
  outside ``with self._lock`` (``__init__`` is pre-publication and
  exempt): one path updates state under the lock, another does not.
* ``lock-order-cycle`` — the cross-class lock-acquisition-order graph
  contains a cycle.  Edges come from nested ``with`` statements and
  from calls made while holding a lock, expanded transitively through
  same-class method calls and through cross-class calls whose method
  name is unique among the analyzed classes.

Locks are attributes assigned ``threading.Lock()``/``RLock()``;
``threading.Condition(self._lock)`` aliases the condition attribute to
its underlying lock (a bare ``Condition()`` is its own lock).  Guarding
is recognized through ``with self.<lock>:`` — the repo convention; the
dynamic watchdog (analysis.lockwatch) covers manual acquire/release.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ParsedFile, dotted

LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
COND_CTORS = {"threading.Condition", "Condition"}


@dataclass
class ClassInfo:
    name: str
    path: str
    locks: Set[str] = field(default_factory=set)  # attr names that ARE locks
    aliases: Dict[str, str] = field(default_factory=dict)  # cond attr -> lock attr
    # attr -> (guarded write lines, unguarded write lines)
    writes: Dict[str, Tuple[List[int], List[int]]] = field(default_factory=dict)
    # method name -> locks directly acquired in it (attr names)
    acquires: Dict[str, Set[str]] = field(default_factory=dict)
    # method name -> [(held lock attr, callee expr, line)]
    calls_under_lock: Dict[str, List[Tuple[str, str, int]]] = field(default_factory=dict)
    # direct nested-with edges: (attrA, attrB, line)
    nested: List[Tuple[str, str, int]] = field(default_factory=list)
    methods: Set[str] = field(default_factory=set)


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _collect_class(cls: ast.ClassDef, path: str) -> ClassInfo:
    info = ClassInfo(cls.name, path)
    # Pass 1: lock attribute discovery, anywhere in the class.
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = dotted(node.value.func) or ""
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if ctor in LOCK_CTORS:
                    info.locks.add(attr)
                elif ctor in COND_CTORS:
                    if node.value.args:
                        under = _self_attr(node.value.args[0])
                        if under:
                            info.aliases[attr] = under
                            continue
                    info.locks.add(attr)

    def resolve(attr: str) -> str:
        return info.aliases.get(attr, attr)

    def is_lock(attr: str) -> bool:
        return resolve(attr) in info.locks

    # Pass 2: per-method walk with the held-lock stack.
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        info.methods.add(meth.name)
        info.acquires.setdefault(meth.name, set())
        info.calls_under_lock.setdefault(meth.name, [])
        in_init = meth.name == "__init__"

        def record_write(attr: str, line: int, held: Tuple[str, ...]) -> None:
            if in_init or is_lock(attr) or attr in info.aliases:
                return
            guarded, unguarded = info.writes.setdefault(attr, ([], []))
            (guarded if held else unguarded).append(line)

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and is_lock(attr):
                        lock = resolve(attr)
                        info.acquires[meth.name].add(lock)
                        if held and held[-1] != lock:
                            info.nested.append((held[-1], lock, node.lineno))
                        acquired.append(lock)
                inner = held + tuple(a for a in acquired if a not in held)
                for stmt in node.body:
                    walk(stmt, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not meth:
                return  # nested def: different execution context
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        record_write(attr, node.lineno, held)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                attr = _self_attr(node.target)
                if attr is not None:
                    record_write(attr, node.lineno, held)
            elif isinstance(node, ast.Call) and held:
                name = dotted(node.func)
                if name is not None and "." in name:
                    info.calls_under_lock[meth.name].append((held[-1], name, node.lineno))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        walk(meth, ())
    return info


def _closure_acquires(classes: Dict[str, ClassInfo]) -> Dict[Tuple[str, str], Set[str]]:
    """(class, method) -> lock node keys ('Cls.attr') transitively
    acquired, expanding self-calls and unique-name cross-class calls."""
    method_owner: Dict[str, List[str]] = {}
    for cname, info in classes.items():
        for m in info.methods:
            method_owner.setdefault(m, []).append(cname)

    out: Dict[Tuple[str, str], Set[str]] = {}
    for cname, info in classes.items():
        for m in info.methods:
            out[(cname, m)] = {f"{cname}.{a}" for a in info.acquires.get(m, set())}

    def callees(cname: str, meth: str):
        info = classes[cname]
        for _, call_name, _ in info.calls_under_lock.get(meth, []):
            parts = call_name.split(".")
            leaf = parts[-1]
            if parts[0] == "self" and len(parts) == 2 and leaf in info.methods:
                yield (cname, leaf)
            else:
                owners = method_owner.get(leaf, [])
                if len(owners) == 1 and owners[0] != cname:
                    yield (owners[0], leaf)

    changed = True
    while changed:
        changed = False
        for key in out:
            for callee in callees(*key):
                if callee in out and not out[callee] <= out[key]:
                    out[key] |= out[callee]
                    changed = True
    return out


def _order_edges(classes: Dict[str, ClassInfo]) -> Dict[Tuple[str, str], Tuple[str, int]]:
    """Edge (lockA -> lockB) -> (path, line) witness."""
    closure = _closure_acquires(classes)
    method_owner: Dict[str, List[str]] = {}
    for cname, info in classes.items():
        for m in info.methods:
            method_owner.setdefault(m, []).append(cname)

    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def add(a: str, b: str, path: str, line: int) -> None:
        if a != b and (a, b) not in edges:
            edges[(a, b)] = (path, line)

    for cname, info in classes.items():
        for a, b, line in info.nested:
            add(f"{cname}.{a}", f"{cname}.{b}", info.path, line)
        for meth, calls in info.calls_under_lock.items():
            for held, call_name, line in calls:
                parts = call_name.split(".")
                leaf = parts[-1]
                targets: List[Tuple[str, str]] = []
                if parts[0] == "self" and len(parts) == 2 and leaf in info.methods:
                    targets.append((cname, leaf))
                else:
                    owners = method_owner.get(leaf, [])
                    if len(owners) == 1 and owners[0] != cname:
                        targets.append((owners[0], leaf))
                for tkey in targets:
                    for lock in closure.get(tkey, set()):
                        add(f"{cname}.{held}", lock, info.path, line)
    return edges


def _find_cycles(edges: Dict[Tuple[str, str], Tuple[str, int]]) -> List[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    cycles: List[List[str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()
    for start in sorted(graph):
        # DFS from start looking for a path back to start.
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        visited: Set[str] = set()
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = tuple(sorted(path))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(path + [start])
                elif nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
    # Deduplicate rotations: keep one witness per node set.
    uniq: Dict[Tuple[str, ...], List[str]] = {}
    for c in cycles:
        uniq.setdefault(tuple(sorted(set(c))), c)
    return list(uniq.values())


def run(files: List[ParsedFile]) -> List[Finding]:
    findings: List[Finding] = []
    classes: Dict[str, ClassInfo] = {}
    for pf in files:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                info = _collect_class(node, pf.path)
                if info.locks:
                    classes[info.name] = info

    for cname in sorted(classes):
        info = classes[cname]
        for attr in sorted(info.writes):
            guarded, unguarded = info.writes[attr]
            if guarded and unguarded:
                findings.append(Finding(
                    "locks", "mixed-lock-write", info.path, unguarded[0],
                    cname, f"{cname}.{attr}",
                    f"{cname}.{attr} written under the lock (line {guarded[0]}) "
                    f"and without it (line {unguarded[0]})",
                ))

    edges = _order_edges(classes)
    for cycle in _find_cycles(edges):
        a, b = cycle[0], cycle[1]
        path, line = edges.get((a, b), ("", 0))
        findings.append(Finding(
            "locks", "lock-order-cycle", path, line, "",
            " -> ".join(cycle),
            f"lock acquisition order cycle: {' -> '.join(cycle)}",
        ))
    return findings


def build_order_report(files: List[ParsedFile]) -> Dict[str, object]:
    """The full tables for --json consumers: per-class write discipline
    and the order graph (used by docs and by tests)."""
    classes: Dict[str, ClassInfo] = {}
    for pf in files:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                info = _collect_class(node, pf.path)
                if info.locks:
                    classes[info.name] = info
    edges = _order_edges(classes)
    return {
        "classes": {
            cname: {
                "locks": sorted(info.locks),
                "mixed": sorted(
                    attr for attr, (g, u) in info.writes.items() if g and u
                ),
            }
            for cname, info in sorted(classes.items())
        },
        "order_edges": sorted(f"{a} -> {b}" for a, b in edges),
    }
