"""CKPT201: blocking calls lexically inside a held-lock scope (the
port's own copy of ``repro/analysis/rules_blocking.py``).

Holding a declared lock across file I/O, sleeps, barrier waits, future
results, thread joins, or storage-backend calls serializes every other
lane behind that I/O — the exact failure mode the engine's overlap design
exists to avoid (and a classic deadlock amplifier when the blocked-on
resource itself needs the lock).

Waiting on a condition variable that *aliases the held lock* (e.g.
``self._freed.wait()`` under ``HostCache._lock``) is the sanctioned
pattern and is never flagged; the alias is resolved through the
``declares_lock`` attr list.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from .linter import (Finding, Project, Rule, SourceModule, call_name,
                     dotted)
from .lockorder import FunctionCtx, HeldScopeWalker, receiver_lastname

# plain-name or dotted-suffix calls that block
_BLOCKING_FUNCS = {
    "sleep", "open", "fsync", "file_checksum", "probe_step_complete",
}
_BLOCKING_OS = {
    "replace", "rename", "remove", "unlink", "makedirs", "listdir",
    "scandir", "stat", "rmdir", "fsync",
}
_BLOCKING_SHUTIL = {
    "copy", "copy2", "copyfile", "copytree", "move", "rmtree",
    "disk_usage",
}
# backend/tier storage operations (blocking network or disk I/O)
_BACKEND_METHODS = {
    "put", "get", "put_file", "get_file", "delete", "list", "exists",
    "size",
}
_BACKENDISH = ("backend", "_local", "local", "tier", "remote", "store")
_THREADISH = ("thread", "worker", "flusher", "committer", "proc",
              "process", "cascade")
_QUEUEISH = ("queue", "_q", ".q")


def _is_backendish(name: str) -> bool:
    low = name.lower()
    return any(tag in low for tag in _BACKENDISH)


def _is_threadish(name: str) -> bool:
    low = name.lower()
    return low == "t" or any(tag in low for tag in _THREADISH)


def _is_queueish(name: str) -> bool:
    low = name.lower()
    return low in ("q", "jobs", "work") or "queue" in low


class BlockingUnderLockRule(Rule):
    id = "CKPT201"
    summary = "blocking call while holding a declared lock"

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []

        def flag(node: ast.Call, what: str,
                 held: List[Tuple[str, int]]) -> None:
            held_s = ", ".join(h for h, _r in held)
            findings.append(Finding(
                rule=self.id, path=module.rel, line=node.lineno,
                col=node.col_offset,
                message=f"{what} while holding [{held_s}]"))

        def on_call(node: ast.Call, held: List[Tuple[str, int]],
                    ctx: FunctionCtx) -> None:
            fn = call_name(node)
            d = dotted(node.func)
            recv = receiver_lastname(node)
            if fn in _BLOCKING_FUNCS and (d == fn or "." not in d
                                          or d.startswith("time.")
                                          or d.startswith("os.")):
                flag(node, f"blocking call {d or fn}()", held)
            elif d.startswith("os.") and fn in _BLOCKING_OS:
                flag(node, f"blocking call {d}()", held)
            elif d.startswith("os.path.") and fn in ("getsize",
                                                     "exists"):
                flag(node, f"blocking call {d}()", held)
            elif d.startswith("shutil.") and fn in _BLOCKING_SHUTIL:
                flag(node, f"blocking call {d}()", held)
            elif fn == "result":
                flag(node, f"future {d or 'result'}() wait", held)
            elif fn == "join" and _is_threadish(recv):
                flag(node, f"thread join {d}()", held)
            elif fn == "get" and _is_queueish(recv):
                flag(node, f"queue get {d}()", held)
            elif fn == "wait":
                # own-condition wait resolves as an acquiring/alias call
                # and never reaches on_call; anything else (events,
                # foreign conditions, futures) blocks under the lock
                flag(node, f"blocking wait {d}()", held)
            elif fn in _BACKEND_METHODS and _is_backendish(recv):
                flag(node, f"storage backend call {d}()", held)

        HeldScopeWalker(module, project, on_call=on_call).walk()
        return iter(findings)


def RULES() -> List[Rule]:
    return [BlockingUnderLockRule()]
