"""CKPT401: snapshot-immutability (the port's own copy of
``repro/analysis/rules_snapshot.py``, for PyTorch's way of writing a
buffer).

The paper's lazy async snapshot premise: once device state is captured
into a pinned host-cache reservation, those bytes are immutable until the
flush lane has drained them — any in-place mutation races the writer and
silently corrupts the checkpoint (no crash, wrong bytes on disk).

The rule taints every name bound to a ``reserve(...)`` result (or a
``.buf``/``.data``/``view()`` of one, or the port's ``Reservation``
views ``.tensor()`` and ``.array()``) and flags writes through tainted
names: subscript stores, augmented assignments, and PyTorch's in-place
tensor methods (a call of a method whose name ends in one underscore,
``.copy_``, ``.add_``, ``.zero_``, on a tainted name, a slice of one or
a view of one). Sanctioned lanes — the capture path itself — are exempt:
all of ``core/state_provider.py`` (providers own the capture protocol),
``_stage_worker`` in ``core/engine.py`` (the staging lane, which copies a
host tensor into its reservation) and ``_launch_d2h`` there (which
enqueues the device-to-host copies into the reservations on the copy
stream, fenced by the events the staging lane waits on).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .linter import Finding, Project, Rule, SourceModule, call_name, \
    dotted

SANCTIONED_MODULES = ("core/state_provider.py",)
SANCTIONED_FUNCTIONS = {"_stage_worker", "_launch_d2h"}
_RESERVATION_ATTRS = ("buf", "data", "view", "memoryview", "tensor",
                      "array")


def _reservation_taint(fn: ast.AST) -> Set[str]:
    tainted: Set[str] = set()
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    for _ in range(3):
        changed = False
        for node in assigns:
            if not _value_tainted(node.value, tainted):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id not in tainted:
                    tainted.add(tgt.id)
                    changed = True
        if not changed:
            break
    return tainted


def _value_tainted(expr: ast.expr, tainted: Set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and call_name(node) == "reserve":
            return True
        if isinstance(node, ast.Name) and node.id in tainted:
            return True
        if isinstance(node, ast.Attribute) and \
                node.attr in _RESERVATION_ATTRS:
            base = dotted(node.value)
            last = base.rsplit(".", 1)[-1] if base else ""
            if last in tainted or "reservation" in last.lower() or \
                    last in ("res", "rsv"):
                return True
    return False


def _base_name(expr: ast.expr) -> str:
    """Leftmost-ish name a subscript/attribute store goes through."""
    cur = expr
    while isinstance(cur, (ast.Subscript, ast.Attribute)):
        cur = cur.value
    if isinstance(cur, ast.Name):
        return cur.id
    return ""


def _in_place_receiver(node: ast.AST) -> Optional[ast.expr]:
    """The tensor an in-place method call (``x.copy_(...)``) writes, with
    the calls that make views of it (``x.view(...)``) walked through;
    ``None`` for any other node."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return None
    name = node.func.attr
    if not name.endswith("_") or name.startswith("_"):
        return None
    cur = node.func.value
    while isinstance(cur, ast.Call) and isinstance(cur.func, ast.Attribute):
        cur = cur.func.value
    return cur


class SnapshotMutationRule(Rule):
    id = "CKPT401"
    summary = ("in-place mutation of a pinned snapshot reservation "
               "outside the capture lane")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if module.rel.endswith(SANCTIONED_MODULES):
            return iter(())
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name in SANCTIONED_FUNCTIONS:
                continue
            tainted = _reservation_taint(fn)
            if not tainted:
                continue
            for node in ast.walk(fn):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        node is not fn:
                    continue  # nested fns get their own taint pass
                targets: List[ast.expr] = []
                what = "store into"
                if isinstance(node, ast.Assign):
                    targets = [t for t in node.targets
                               if isinstance(t, ast.Subscript)]
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(node.target, ast.Subscript):
                    targets = [node.target]
                elif _in_place_receiver(node) is not None:
                    targets = [_in_place_receiver(node)]
                    what = f"in-place {node.func.attr}() on"
                for tgt in targets:
                    base = _base_name(tgt)
                    if base and base in tainted:
                        findings.append(Finding(
                            rule=self.id, path=module.rel,
                            line=node.lineno, col=node.col_offset,
                            message=(f"{what} reservation-backed "
                                     f"buffer {base!r}; staged bytes "
                                     f"are immutable between capture "
                                     f"and flush")))
        return iter(findings)


def RULES() -> List[Rule]:
    return [SnapshotMutationRule()]
