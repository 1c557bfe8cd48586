"""API-hygiene rules (CKPT5xx; the port's own copy of
``repro/analysis/rules_hygiene.py``).

The public surface is ``CheckpointPolicy`` + the
``StateProviderRegistry``; internal code must not re-grow calls into the
deprecated flat kwargs or hand-build stock providers outside the routing
layer, or the policy/provider composition stops being the single source
of truth.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from .linter import Finding, Project, Rule, SourceModule, call_name

#: flat CheckpointManager kwargs deprecated by CheckpointPolicy
LEGACY_KWARGS = {
    "mode", "host_cache_bytes", "flush_threads", "chunk_bytes",
    "throttle_mbps", "restore_threads", "tiers", "retention",
    "manifest_checksums", "world", "coordinator", "ack_timeout_s",
    "delta",
}

#: stock provider classes whose construction is routed by the registry
STOCK_PROVIDERS = {
    "TensorStateProvider", "ObjectStateProvider", "DeltaStateProvider",
    "QuantizedStateProvider", "CompositeStateProvider",
}
#: modules that ARE the routing/definition layer (may construct freely)
SANCTIONED_PROVIDER_MODULES = (
    "core/state_provider.py", "core/registry.py", "core/baselines.py",
)


class LegacyKwargsRule(Rule):
    id = "CKPT501"
    summary = ("CheckpointManager called with deprecated flat kwargs; "
               "compose a CheckpointPolicy instead")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "CheckpointManager"):
                continue
            bad = sorted(kw.arg for kw in node.keywords
                         if kw.arg in LEGACY_KWARGS)
            if bad:
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"deprecated legacy kwargs "
                             f"{', '.join(bad)}; use "
                             f"CheckpointManager.from_policy("
                             f"directory, CheckpointPolicy(...))")))
        return iter(findings)


class ProviderBypassRule(Rule):
    id = "CKPT502"
    summary = ("stock provider constructed outside the registry routing "
               "layer; use StateProviderRegistry / providers_for_state")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if module.rel.endswith(SANCTIONED_PROVIDER_MODULES):
            return iter(())
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and \
                    call_name(node) in STOCK_PROVIDERS:
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=(f"{call_name(node)}(...) bypasses "
                             f"StateProviderRegistry routing; resolve "
                             f"providers through the registry")))
        return iter(findings)


class DeprecatedReducerRule(Rule):
    id = "CKPT503"
    summary = ("reference to deprecated DifferentialCheckpointer outside "
               "its home module; use delta providers via the engine path")

    def check(self, module: SourceModule,
              project: Project) -> Iterator[Finding]:
        if module.rel.endswith("core/reduction.py"):
            return iter(())
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            name = None
            if isinstance(node, ast.Name) and \
                    node.id == "DifferentialCheckpointer":
                name = node.id
            elif isinstance(node, ast.Attribute) and \
                    node.attr == "DifferentialCheckpointer":
                name = node.attr
            elif isinstance(node, ast.ImportFrom) and any(
                    a.name == "DifferentialCheckpointer"
                    for a in node.names):
                name = "DifferentialCheckpointer"
            if name is not None:
                findings.append(Finding(
                    rule=self.id, path=module.rel, line=node.lineno,
                    col=node.col_offset,
                    message=("DifferentialCheckpointer is deprecated; "
                             "use DeltaStateProvider through the "
                             "engine delta path")))
        return iter(findings)


def RULES() -> List[Rule]:
    return [LegacyKwargsRule(), ProviderBypassRule(),
            DeprecatedReducerRule()]
