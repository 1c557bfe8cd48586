"""``ckptlint`` rule engine: AST loading, suppressions, rule running (the
port's own copy of ``repro/analysis/linter.py``).

The analyzer is project-native and stdlib-only (``ast`` + ``os``): it
knows this codebase's concurrency and commit-protocol conventions and
checks them mechanically on every PR. Rules live in sibling modules
(:mod:`.lockorder`, :mod:`.rules_blocking`, :mod:`.rules_commit`,
:mod:`.rules_snapshot`, :mod:`.rules_hygiene`); each rule yields
:class:`Finding` objects with precise file:line anchors.

Suppression: append ``# ckptlint: disable=RULE`` (comma-separated for
several rules, or ``all``) to the offending line, or put the comment on
its own line directly above the statement. Every suppression in this
repository must carry an inline justification, which the clean-tree
test holds.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, \
    Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*ckptlint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation anchored to a source location."""

    rule: str
    path: str           # display (relative) path
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{tag} " \
               f"{self.message}"


class SourceModule:
    """One parsed file: source, AST (with parent links), suppressions."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]
        self.suppressions = self._parse_suppressions(source)

    @staticmethod
    def _parse_suppressions(source: str) -> Dict[int, Set[str]]:
        """line number -> suppressed rule ids (``{"all"}`` disables all).

        Comments are found with the tokenizer, not a substring scan, so a
        ``# ckptlint:`` inside a string literal is never a suppression.
        """
        out: Dict[int, Set[str]] = {}
        lines = source.splitlines()
        try:
            tokens = list(tokenize.generate_tokens(
                iter(lines).__next__ if False else
                (line + "\n" for line in lines).__next__))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            lineno = tok.start[0]
            target = lineno
            # a comment alone on its line applies to the next code line
            if lines[lineno - 1].lstrip().startswith("#"):
                target = lineno + 1
            out.setdefault(target, set()).update(rules)
        return out

    def is_suppressed(self, rule: str, line: int) -> bool:
        for probe in (line,):
            rules = self.suppressions.get(probe)
            if rules and (rule.upper() in rules or "ALL" in rules):
                return True
        return False


class Project:
    """All modules under analysis plus the statically-extracted lock
    declarations (``@declares_lock`` / ``named_lock`` call sites)."""

    def __init__(self, modules: Sequence[SourceModule]):
        self.modules = list(modules)
        # class name -> {attr -> (lock name, rank)}; merged project-wide
        # (class names are unique enough in this codebase; collisions
        # would merge attr maps, which is safe for alias resolution).
        self.class_lock_attrs: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # class name -> base class names (for inherited lock attrs)
        self.class_bases: Dict[str, List[str]] = {}
        # lock name -> declared rank
        self.hierarchy: Dict[str, int] = {}
        # (module rel, lock name) -> declaration line (for diagnostics)
        self.decl_sites: Dict[str, Tuple[str, int]] = {}
        for mod in self.modules:
            self._collect_declarations(mod)

    # ---------------------------------------------------------- declarations
    def _collect_declarations(self, mod: SourceModule) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                self.class_bases[node.name] = [
                    b.id if isinstance(b, ast.Name) else
                    b.attr if isinstance(b, ast.Attribute) else ""
                    for b in node.bases]
                for deco in node.decorator_list:
                    decl = self._parse_declares_lock(deco)
                    if decl is None:
                        continue
                    name, rank, attrs = decl
                    amap = self.class_lock_attrs.setdefault(node.name, {})
                    for attr in attrs:
                        amap[attr] = (name, rank)
                    self._note_rank(mod, name, rank, deco.lineno)
            elif isinstance(node, ast.Call):
                fn = call_name(node)
                if fn in ("named_lock", "named_condition"):
                    name = const_str(node.args[0]) if node.args else None
                    rank = kw_int(node, "rank")
                    if name is not None and rank is not None:
                        self._note_rank(mod, name, rank, node.lineno)

    def _note_rank(self, mod: SourceModule, name: str, rank: int,
                   line: int) -> None:
        self.hierarchy.setdefault(name, rank)
        self.decl_sites.setdefault(name, (mod.rel, line))

    @staticmethod
    def _parse_declares_lock(deco: ast.expr
                             ) -> Optional[Tuple[str, int, List[str]]]:
        if not isinstance(deco, ast.Call) or \
                call_name(deco) != "declares_lock":
            return None
        name = const_str(deco.args[0]) if deco.args else None
        rank = kw_int(deco, "rank")
        attrs: List[str] = []
        for kw in deco.keywords:
            if kw.arg == "attrs" and isinstance(kw.value,
                                                (ast.Tuple, ast.List)):
                attrs = [e.value for e in kw.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
        if name is None or rank is None:
            return None
        return name, rank, attrs

    # -------------------------------------------------------------- lookups
    def lock_attrs_for_class(self, cls: str) -> Dict[str,
                                                     Tuple[str, int]]:
        """Declared lock attrs of ``cls`` including inherited ones."""
        out: Dict[str, Tuple[str, int]] = {}
        seen: Set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            for attr, decl in self.class_lock_attrs.get(c, {}).items():
                out.setdefault(attr, decl)
            stack.extend(self.class_bases.get(c, ()))
        return out


class Rule:
    """Base class: subclasses set ``id``/``summary`` and yield findings."""

    id: str = ""
    summary: str = ""

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        return iter(())

    def finalize(self, project: Project) -> Iterator[Finding]:
        """Cross-module pass after every module was checked."""
        return iter(())


# --------------------------------------------------------------- AST helpers
def call_name(node: ast.Call) -> str:
    """Last path component of the called function (``a.b.f(...)`` -> f)."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def dotted(node: ast.expr) -> str:
    """Best-effort dotted name for Name/Attribute chains, else ''."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif parts:
        parts.append("")  # unknown base (call result, subscript, ...)
    return ".".join(reversed(parts))


def const_str(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def kw_int(node: ast.Call, name: str) -> Optional[int]:
    for kw in node.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, int):
            return kw.value.value
    return None


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def enclosing_function(node: ast.AST
                       ) -> Optional[ast.FunctionDef]:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


# ------------------------------------------------------------------- running
def iter_python_files(paths: Sequence[str],
                      include_analysis: bool = False) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git",
                                              ".pytest_cache"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _is_analysis_module(rel: str) -> bool:
    rel = rel.replace(os.sep, "/")
    return "repro/analysis/" in rel or "repro_torch/analysis/" in rel \
        or rel.startswith("analysis/")


def load_modules(paths: Sequence[str], *, root: Optional[str] = None,
                 include_analysis: bool = False
                 ) -> Tuple[List[SourceModule], List[Finding]]:
    """Parse every .py under ``paths``; unparseable files become findings
    (a syntax error must fail the gate, not silently shrink coverage)."""
    root = root or os.getcwd()
    modules: List[SourceModule] = []
    errors: List[Finding] = []
    for path in iter_python_files(paths):
        rel = os.path.relpath(path, root)
        if not include_analysis and _is_analysis_module(rel):
            continue  # the linter does not lint itself
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            modules.append(SourceModule(path, rel, source))
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            errors.append(Finding(
                rule="CKPT000", path=rel, line=getattr(exc, "lineno", 1)
                or 1, col=0, message=f"unparseable file: {exc}"))
    return modules, errors


def all_rules() -> List[Rule]:
    from . import (lockorder, rules_blocking, rules_commit,
                   rules_hygiene, rules_snapshot)
    rules: List[Rule] = []
    for mod in (lockorder, rules_blocking, rules_commit,
                rules_snapshot, rules_hygiene):
        rules.extend(mod.RULES())
    return rules


def run(paths: Sequence[str], *, root: Optional[str] = None,
        select: Optional[Iterable[str]] = None,
        include_analysis: bool = False
        ) -> Tuple[List[Finding], List[Finding]]:
    """Analyze ``paths``; returns (active findings, suppressed findings),
    both sorted by location."""
    modules, errors = load_modules(paths, root=root,
                                   include_analysis=include_analysis)
    project = Project(modules)
    rules = all_rules()
    if select is not None:
        wanted = {s.upper() for s in select}
        rules = [r for r in rules
                 if r.id.upper() in wanted
                 or any(r.id.upper().startswith(w) for w in wanted)]
    raw: List[Finding] = list(errors)
    for rule in rules:
        for mod in modules:
            raw.extend(rule.check(mod, project))
        raw.extend(rule.finalize(project))
    by_rel = {m.rel: m for m in modules}
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        mod = by_rel.get(f.path)
        if mod is not None and mod.is_suppressed(f.rule, f.line):
            suppressed.append(dataclasses.replace(f, suppressed=True))
        else:
            active.append(f)
    key = lambda f: (f.path, f.line, f.col, f.rule)  # noqa: E731
    return sorted(active, key=key), sorted(suppressed, key=key)
