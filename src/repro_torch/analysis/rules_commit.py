"""Commit-protocol rules (CKPT3xx; the port's own copy of
``repro/analysis/rules_commit.py``).

The durable-state discipline (see README "Correctness tooling"): every
byte under the repository root — ``.catalog/`` entries and
``global_step*`` directories — is produced either by ``FileWriter``
(tensor shards, with ``abort()`` unlinking partials) or by the atomic
tmp-then-``os.replace`` helpers in ``storage/backend.py`` /
``storage/manifest.py``, and the ``StepManifest`` is always written
*last*. Raw ``open(..., "w")`` or bare ``os.rename``/``os.replace`` on
such paths can leave half-committed state that restore then trusts —
the dominant production failure mode this repo's fault suites replay.

Taint: a path expression is "repository-owned" when it derives from the
key/path helpers (``step_dir``, ``catalog_key``, ``_marker_path``, ...),
contains the ``.catalog``/``global_step`` markers, or flows from such a
value through local assignments (intra-function, flow-insensitive).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set

from .linter import (Finding, Project, Rule, SourceModule, call_name,
                     const_str, dotted)

#: modules allowed to do raw writes/renames on repository-owned paths —
#: they ARE the sanctioned atomic helpers.
SANCTIONED_WRITE_MODULES = (
    "storage/backend.py", "storage/manifest.py", "core/layout.py",
)
#: modules allowed to construct FileWriter directly (the engine's flush
#: lane and the shard consolidator, both of which abort() on failure).
SANCTIONED_WRITER_MODULES = (
    "core/layout.py", "core/engine.py", "core/consolidate.py",
)

_PATH_HELPERS = {
    "step_dir", "step_dirname", "catalog_key", "data_key", "entry_name",
    "marker_name", "rank_file", "_entry_path", "_marker_path",
    "_catalog_path", "_step_path",
}
_TAINT_MARKERS = (".catalog", "global_step")
_TAINT_NAMES = {"sdir", "staging", "step_path", "marker_path"}


def _function_taint(fn: ast.AST) -> Set[str]:
    """Names in ``fn`` bound (directly or transitively) to
    repository-owned paths."""
    tainted: Set[str] = set(_TAINT_NAMES)
    assigns: List[ast.Assign] = [n for n in ast.walk(fn)
                                 if isinstance(n, ast.Assign)]
    for _ in range(3):  # tiny fixpoint; chains here are short
        changed = False
        for node in assigns:
            if not _expr_tainted(node.value, tainted):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id not in tainted:
                    tainted.add(tgt.id)
                    changed = True
        if not changed:
            break
    return tainted


def _expr_tainted(expr: ast.expr, tainted: Set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in tainted:
            return True
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                any(m in node.value for m in _TAINT_MARKERS):
            return True
        if isinstance(node, ast.Call) and \
                call_name(node) in _PATH_HELPERS:
            return True
        if isinstance(node, ast.Attribute):
            d = dotted(node)
            if "catalog" in d or d.endswith(".directory"):
                return True
    return False


def _enclosing_fn(node: ast.AST) -> ast.AST:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return node  # module scope


class RawWriteRule(Rule):
    id = "CKPT301"
    summary = ("raw open(..., 'w') on a repository-owned path; use the "
               "atomic helpers (backend.put / StepManifest / FileWriter)")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if module.rel.endswith(SANCTIONED_WRITE_MODULES):
            return iter(())
        findings: List[Finding] = []
        taint_cache: Dict[int, Set[str]] = {}
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "open"
                    and isinstance(node.func, ast.Name)):
                continue
            mode = ""
            if len(node.args) > 1:
                mode = const_str(node.args[1]) or ""
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = const_str(kw.value) or ""
            if not any(c in mode for c in "wax+"):
                continue
            if not node.args:
                continue
            fn = _enclosing_fn(node)
            tainted = taint_cache.setdefault(id(fn), _function_taint(fn))
            if _expr_tainted(node.args[0], tainted):
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"raw open(..., {mode!r}) writes a "
                             f"repository-owned path; route through the "
                             f"atomic backend/manifest helpers")))
        return iter(findings)


class RawRenameRule(Rule):
    id = "CKPT302"
    summary = ("bare os.rename/os.replace on a repository-owned path "
               "outside the sanctioned helpers")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if module.rel.endswith(SANCTIONED_WRITE_MODULES):
            return iter(())
        findings: List[Finding] = []
        taint_cache: Dict[int, Set[str]] = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d not in ("os.rename", "os.replace"):
                continue
            fn = _enclosing_fn(node)
            tainted = taint_cache.setdefault(id(fn), _function_taint(fn))
            if any(_expr_tainted(a, tainted) for a in node.args):
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"{d} on a repository-owned path; commits "
                             f"must go through the manifest-last "
                             f"protocol helpers")))
        return iter(findings)


class WriterConstructionRule(Rule):
    id = "CKPT303"
    summary = ("FileWriter constructed outside the flush/consolidate "
               "lanes (abort-on-failure discipline not guaranteed)")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if module.rel.endswith(SANCTIONED_WRITER_MODULES):
            return iter(())
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and \
                    call_name(node) == "FileWriter":
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=("FileWriter constructed outside the "
                             "sanctioned lanes; wrap in the engine "
                             "flush path or consolidator (both abort() "
                             "and unlink partials on failure)")))
        return iter(findings)


class FinalizeInExceptRule(Rule):
    id = "CKPT304"
    summary = ("finalize() inside an except handler — abort paths must "
               "unlink partials, not seal them")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "finalize"):
                continue
            cur = getattr(node, "parent", None)
            inside_handler = False
            while cur is not None:
                if isinstance(cur, ast.ExceptHandler):
                    inside_handler = True
                    break
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    break
                cur = getattr(cur, "parent", None)
            if inside_handler:
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=("finalize() called in an except handler; "
                             "error paths must abort() so partial "
                             "files are unlinked, never sealed")))
        return iter(findings)


def RULES() -> List[Rule]:
    return [RawWriteRule(), RawRenameRule(), WriterConstructionRule(),
            FinalizeInExceptRule()]
