"""Lock-order rules (CKPT1xx) and the shared held-lock scope walker (the
port's own copy of ``repro/analysis/lockorder.py``).

The hierarchy itself is *declared in the code* via
:func:`repro_torch.analysis.locks.declares_lock` / ``named_lock`` call
sites;
this module extracts nothing from a config file. The walker computes, for
every statement, the set of locks lexically held (``with`` scopes plus
bare ``acquire()``), resolving lock expressions through three stages:

1. ``self.<attr>`` against the enclosing class's declared lock attrs
   (inheritance-merged) — the precise path;
2. local names bound by ``named_lock(...)`` / ``named_condition(...)``;
3. a project-native table of *acquiring methods* — calls such as
   ``host_cache.reserve(...)`` or ``barrier.wait(...)`` that take a known
   lock internally, so cross-object acquisition edges are visible without
   interprocedural analysis.

Rules:

- **CKPT101** out-of-order acquisition: acquiring a lock whose declared
  rank is not strictly greater than every held rank.
- **CKPT102** lock-graph cycle: the project-wide acquisition graph
  (nesting edges from every file) must be acyclic.
- **CKPT103** undeclared lock: a raw ``threading.Lock/RLock/Condition``
  constructed in a hierarchy-scoped module without a ``declares_lock`` /
  ``named_lock`` declaration.
- **CKPT104** bare ``acquire()`` without a ``try/finally`` ``release()``.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from .linter import (Finding, Project, Rule, SourceModule, call_name,
                     const_str, dotted, enclosing_class, kw_int)

# The port's modules that must declare every lock they construct
# (CKPT103); the port keeps the JAX package's layout, so the suffixes are
# the same. Any module that already contains a declaration is also in
# scope.
SCOPED_SUFFIXES = (
    "core/engine.py", "core/host_cache.py", "core/layout.py",
    "core/state_provider.py", "core/checkpoint.py", "dist/barrier.py",
    "dist/coordinator.py", "storage/repository.py",
)

#: method name -> (lock it acquires internally, receiver last-name guard):
#: the port's acquiring methods, each lock a name of
#: ``repro_torch.analysis.locks.LOCK_REGISTRY``.
#: A ``None`` guard accepts any receiver; otherwise the receiver's last
#: dotted component must be in the set (so ``event.wait()`` is not
#: mistaken for a barrier wait).
ACQUIRING_METHODS: Dict[str, Tuple[str, Optional[Set[str]]]] = {
    "reserve": ("host_cache.alloc",
                {"host_cache", "_cache", "cache", "hc"}),
    "wait": ("barrier.cond", {"barrier", "_barrier"}),
    "wait_generation": ("barrier.cond", {"barrier", "_barrier"}),
    "poison": ("barrier.cond", {"barrier", "_barrier"}),
    "reset": ("barrier.cond", {"barrier", "_barrier"}),
    "append_object": ("writer.append", None),
    "append_encoded_chunk": ("writer.append", None),
    "declare_encoded_tensor": ("writer.append", None),
    "op_started": ("engine.file_state", None),
    "op_finished": ("engine.file_state", None),
    "producer_finished": ("engine.file_state", None),
    "begin_step": ("repository.state", None),
    "commit_step": ("repository.state", None),
    "abort_step": ("repository.state", None),
}


def receiver_of(call: ast.Call) -> Optional[ast.expr]:
    if isinstance(call.func, ast.Attribute):
        return call.func.value
    return None


def receiver_lastname(call: ast.Call) -> str:
    recv = receiver_of(call)
    if recv is None:
        return ""
    d = dotted(recv)
    return d.rsplit(".", 1)[-1] if d else ""


class FunctionCtx:
    """Lock-resolution context for one function body."""

    def __init__(self, module: SourceModule, project: Project,
                 fn: ast.AST):
        self.module = module
        self.project = project
        cls = enclosing_class(fn)
        self.attr_locks: Dict[str, Tuple[str, int]] = (
            project.lock_attrs_for_class(cls.name) if cls else {})
        # local name -> (lock name, rank) from named_lock assignments
        self.local_locks: Dict[str, Tuple[str, int]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    call_name(node.value) in ("named_lock",
                                              "named_condition"):
                name = const_str(node.value.args[0]) \
                    if node.value.args else None
                rank = kw_int(node.value, "rank")
                if name is None or rank is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.local_locks[tgt.id] = (name, rank)

    def resolve(self, expr: ast.expr) -> Optional[Tuple[str, int]]:
        """Lock (name, rank) for an expression naming a lock, else None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id in ("self", "cls"):
            return self.attr_locks.get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.local_locks.get(expr.id)
        return None

    def resolve_acquiring_call(self, call: ast.Call
                               ) -> Optional[Tuple[str, int]]:
        """Lock acquired *inside* ``call``, if the call is an acquiring
        method (directly on a lock, or via the project table)."""
        fn = call_name(call)
        recv = receiver_of(call)
        if fn in ("acquire", "__enter__") and recv is not None:
            return self.resolve(recv)
        if recv is not None:
            hit = self.resolve(recv)
            if hit is not None and fn in ("wait", "wait_for", "notify",
                                          "notify_all"):
                # condition built over a declared lock: alias of it
                return hit
        entry = ACQUIRING_METHODS.get(fn)
        if entry is None:
            return None
        name, guard = entry
        if guard is not None and receiver_lastname(call) not in guard:
            return None
        rank = self.project.hierarchy.get(name)
        if rank is None:
            return None
        return name, rank


class HeldScopeWalker:
    """Drives callbacks with the lexically-held lock stack.

    ``on_acquire(name, rank, node, held)`` fires at every resolved
    acquisition (``with`` item, bare ``acquire()``, acquiring call);
    ``on_call(call, held, ctx)`` fires for every other call while at
    least one lock is held. Nested ``def``/``lambda`` bodies run on their
    own threads-of-control, so they restart with an empty held stack.
    """

    def __init__(self, module: SourceModule, project: Project,
                 on_acquire: Optional[Callable[..., None]] = None,
                 on_call: Optional[Callable[..., None]] = None):
        self.module = module
        self.project = project
        self.on_acquire = on_acquire or (lambda *a: None)
        self.on_call = on_call or (lambda *a: None)

    def walk(self) -> None:
        self._walk_body(self.module.tree.body, None, [])

    # ------------------------------------------------------------ internals
    def _walk_body(self, stmts: List[ast.stmt],
                   ctx: Optional[FunctionCtx],
                   held: List[Tuple[str, int]]) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt, ctx, held)

    def _walk_stmt(self, stmt: ast.stmt, ctx: Optional[FunctionCtx],
                   held: List[Tuple[str, int]]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = FunctionCtx(self.module, self.project, stmt)
            self._walk_body(stmt.body, sub, [])  # fresh thread of control
            return
        if isinstance(stmt, ast.ClassDef):
            self._walk_body(stmt.body, ctx, [])
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                self._scan_expr(item.context_expr, ctx, held)
                hit = ctx.resolve(item.context_expr) if ctx else None
                if hit is None and isinstance(item.context_expr,
                                              ast.Call) and ctx:
                    hit = ctx.resolve_acquiring_call(item.context_expr)
                if hit is not None:
                    self.on_acquire(hit[0], hit[1], item.context_expr,
                                    list(held))
                    held.append(hit)
                    pushed += 1
            self._walk_body(stmt.body, ctx, held)
            for _ in range(pushed):
                held.pop()
            return
        for field in ast.iter_fields(stmt):
            _name, value = field
            for part in (value if isinstance(value, list) else [value]):
                if isinstance(part, ast.stmt):
                    self._walk_stmt(part, ctx, held)
                elif isinstance(part, ast.expr):
                    self._scan_expr(part, ctx, held)
                elif isinstance(part, ast.excepthandler):
                    self._walk_body(part.body, ctx, held)

    def _scan_expr(self, expr: ast.expr, ctx: Optional[FunctionCtx],
                   held: List[Tuple[str, int]]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda,)):
                continue  # deferred body: not this thread of control, and
                # lambdas in this codebase never take locks
            if not isinstance(node, ast.Call) or ctx is None:
                continue
            hit = ctx.resolve_acquiring_call(node)
            if hit is not None:
                self.on_acquire(hit[0], hit[1], node, list(held))
            elif held:
                self.on_call(node, list(held), ctx)


class LockOrderRule(Rule):
    id = "CKPT101"
    summary = ("lock acquired out of declared rank order "
               "(risk of ABBA deadlock)")

    def __init__(self) -> None:
        # (outer, inner) -> first site, shared with the cycle rule
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._findings: List[Finding] = []

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []

        def on_acquire(name: str, rank: int, node: ast.AST,
                       held: List[Tuple[str, int]]) -> None:
            if not held:
                return
            if any(name == h for h, _r in held):
                return  # reentrant / alias of an already-held lock
            top_name, _ = held[-1]
            self.edges.setdefault((top_name, name),
                                  (module.rel, node.lineno))
            worst = max(r for _h, r in held)
            if rank <= worst:
                chain = " -> ".join(f"{h}(r{r})" for h, r in held)
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"acquires {name}(r{rank}) while holding "
                             f"[{chain}]; ranks must strictly increase "
                             f"inward")))

        HeldScopeWalker(module, project, on_acquire=on_acquire).walk()
        return iter(findings)


class LockCycleRule(Rule):
    id = "CKPT102"
    summary = "cycle in the project-wide lock-acquisition graph"

    def __init__(self, order_rule: LockOrderRule):
        self._order = order_rule

    def finalize(self, project: Project) -> Iterator[Finding]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self._order.edges:
            graph.setdefault(a, set()).add(b)
        seen: Set[str] = set()
        reported: Set[frozenset] = set()
        findings: List[Finding] = []

        def dfs(node: str, path: List[str]) -> None:
            if node in path:
                cycle = path[path.index(node):] + [node]
                key = frozenset(cycle)
                if key not in reported:
                    reported.add(key)
                    edge = (cycle[0], cycle[1])
                    rel, line = self._order.edges.get(
                        edge, ("<unknown>", 1))
                    findings.append(Finding(
                        rule=self.id, path=rel, line=line, col=0,
                        message=("lock-acquisition cycle: "
                                 + " -> ".join(cycle))))
                return
            if node in seen:
                return
            seen.add(node)
            for nxt in sorted(graph.get(node, ())):
                dfs(nxt, path + [node])
            # allow other entry points to re-explore through this node
            # only via the `node in path` cycle check above

        for start in sorted(graph):
            dfs(start, [])
        return iter(findings)


class UndeclaredLockRule(Rule):
    id = "CKPT103"
    summary = ("raw threading lock in a hierarchy-scoped module without "
               "a declares_lock/named_lock declaration")

    _CTORS = ("Lock", "RLock", "Condition")

    def _in_scope(self, module: SourceModule) -> bool:
        if module.rel.endswith(SCOPED_SUFFIXES):
            return True
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and call_name(node) in (
                    "declares_lock", "named_lock", "named_condition"):
                return True
        return False

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if not self._in_scope(module):
            return iter(())
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            if not (isinstance(val, ast.Call)
                    and call_name(val) in self._CTORS):
                continue
            d = dotted(val.func)
            if d and "." in d and not d.startswith("threading."):
                continue  # some other module's Lock/Condition
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    cls = enclosing_class(node)
                    declared = project.lock_attrs_for_class(
                        cls.name) if cls else {}
                    if tgt.attr not in declared:
                        findings.append(Finding(
                            rule=self.id, path=module.rel,
                            line=node.lineno, col=node.col_offset,
                            message=(f"self.{tgt.attr} = threading."
                                     f"{call_name(val)}() has no "
                                     f"declares_lock(...) covering "
                                     f"attr {tgt.attr!r}")))
                elif isinstance(tgt, ast.Name):
                    findings.append(Finding(
                        rule=self.id, path=module.rel, line=node.lineno,
                        col=node.col_offset,
                        message=(f"local lock {tgt.id!r} should be "
                                 f"created via named_lock(name, rank=N) "
                                 f"so it joins the declared hierarchy")))
        return iter(findings)


class BareAcquireRule(Rule):
    id = "CKPT104"
    summary = "bare acquire() without a try/finally release()"

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)
                    and call_name(node.value) == "acquire"):
                continue
            call = node.value
            recv = receiver_of(call)
            if recv is None:
                continue
            fn = None
            cur = getattr(node, "parent", None)
            while cur is not None and fn is None:
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    fn = cur
                cur = getattr(cur, "parent", None)
            if fn is None:
                continue
            ctx = FunctionCtx(module, project, fn)
            if ctx.resolve(recv) is None:
                continue  # not a declared lock (e.g. a semaphore)
            recv_src = dotted(recv)
            if self._released_in_finally(node, recv_src):
                continue
            findings.append(Finding(
                rule=self.id, path=module.rel, line=node.lineno,
                col=node.col_offset,
                message=(f"{recv_src}.acquire() has no try/finally "
                         f"{recv_src}.release(); prefer `with`")))
        return iter(findings)

    @staticmethod
    def _released_in_finally(node: ast.AST, recv_src: str) -> bool:
        cur = getattr(node, "parent", None)
        while cur is not None:
            if isinstance(cur, ast.Try):
                for stmt in ast.walk(ast.Module(body=cur.finalbody,
                                                type_ignores=[])):
                    if isinstance(stmt, ast.Call) and \
                            call_name(stmt) == "release" and \
                            isinstance(stmt.func, ast.Attribute) and \
                            dotted(stmt.func.value) == recv_src:
                        return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            cur = getattr(cur, "parent", None)
        return False


def RULES() -> List[Rule]:
    order = LockOrderRule()
    return [order, LockCycleRule(order), UndeclaredLockRule(),
            BareAcquireRule()]
