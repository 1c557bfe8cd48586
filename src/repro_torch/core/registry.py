"""State-provider registry: declarative routing of state leaves (paper §V-A3).

The paper's composable state providers decouple *what a piece of state is*
(device tensor, optimizer moment, Python object) from *how it moves*. This
module makes that composition user-facing: a
:class:`StateProviderRegistry` holds an **ordered** list of
:class:`ProviderRule`\\ s, and every leaf of a named state domain
(``{"model": params, "optimizer": opt_state, "dataloader": ..., ...}``)
is routed by the **first matching rule** to a provider:

* ``"tensor"``     — raw zero-copy streaming
  (:class:`~repro_torch.core.state_provider.TensorStateProvider`);
* ``"object"``     — lazily-serialized Python state
  (:class:`~repro_torch.core.state_provider.ObjectStateProvider`);
* ``"delta"``      — XOR differential encoding under the manager's
  :class:`~repro_torch.core.policy.DeltaPolicy` chain schedule
  (:class:`~repro_torch.core.state_provider.DeltaStateProvider`);
* ``"quantized"``  — per-row int8 quantization of fp32 state on the
  engine's device
  (:class:`~repro_torch.core.state_provider.QuantizedStateProvider`) — e.g.
  optimizer moments at 4× reduction while params stay raw;
* ``"auto"``       — the adaptive default: delta when the save is
  differential, raw otherwise (exactly the pre-registry behavior);
* any name registered through :meth:`StateProviderRegistry.register` — a
  user factory returning a
  :class:`~repro_torch.core.state_provider.TensorStateProvider` subclass.

Rules match on any combination of domain name, state-path regex, dtype,
size thresholds, and leaf kind (tensor vs object). Matching happens once
per leaf at shard-planning time (``core.distributed.plan_shards``); the
resolved :class:`ProviderRoute` rides each
:class:`~repro_torch.core.distributed.ShardRecord`, so single-writer engines and
every rank lane of a multi-writer
coordinator (not yet ported) honor the same routing
without re-consulting the registry.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, \
    Tuple, Union

#: provider names with built-in construction paths in the engines.
STOCK_PROVIDERS = ("auto", "tensor", "object", "delta", "quantized")

#: stock providers a tensor leaf may route to.
_TENSOR_PROVIDERS = ("auto", "tensor", "delta", "quantized")
#: stock providers an object leaf may route to.
_OBJECT_PROVIDERS = ("auto", "object")


class RegistryError(ValueError):
    """A leaf could not be routed, or a rule references an unknown or
    incompatible provider."""


@dataclasses.dataclass(frozen=True)
class ProviderRoute:
    """The resolved routing decision for one state leaf.

    ``factory`` is set for user-registered providers (the registry attaches
    the callable at routing time so engines never need the registry
    itself); stock providers are constructed by name inside the engine.
    """

    provider: str
    options: Tuple[Tuple[str, Any], ...] = ()
    rule_index: int = -1
    factory: Optional[Callable[..., Any]] = None

    def option(self, key: str, default: Any = None) -> Any:
        for k, v in self.options:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class ProviderRule:
    """One ordered matching rule. ``None`` predicates match everything, so
    a rule with no predicates is a catch-all; rules are tried in registry
    order and the first match wins (overlaps resolve by position)."""

    provider: str
    domain: Optional[str] = None            # exact state-domain name
    path_regex: Optional[str] = None        # re.search on the full state path
    dtype: Optional[Union[str, Sequence[str]]] = None
    min_nbytes: Optional[int] = None
    max_nbytes: Optional[int] = None        # exclusive upper bound
    kind: Optional[str] = None              # "tensor" | "object"
    options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.kind not in (None, "tensor", "object"):
            raise RegistryError(
                f"rule kind must be 'tensor' or 'object', got {self.kind!r}")
        if self.path_regex is not None:
            object.__setattr__(self, "_re", re.compile(self.path_regex))
        else:
            object.__setattr__(self, "_re", None)
        if isinstance(self.options, dict):
            object.__setattr__(self, "options",
                               tuple(sorted(self.options.items())))

    def matches(self, *, domain: str, path: str, dtype: Optional[str],
                nbytes: Optional[int], kind: str) -> bool:
        if self.kind is not None and self.kind != kind:
            return False
        if self.domain is not None and self.domain != domain:
            return False
        if self._re is not None and not self._re.search(path):
            return False
        if self.dtype is not None:
            allowed = ((self.dtype,) if isinstance(self.dtype, str)
                       else tuple(self.dtype))
            if dtype not in allowed:
                return False
        if self.min_nbytes is not None and (nbytes is None
                                            or nbytes < self.min_nbytes):
            return False
        if self.max_nbytes is not None and (nbytes is None
                                            or nbytes >= self.max_nbytes):
            return False
        return True


class StateProviderRegistry:
    """Ordered, composable leaf→provider routing rules.

    ``strict=True`` turns an unmatched leaf into a hard
    :class:`RegistryError` naming the state path — use it to guarantee
    every domain was consciously routed. The default (non-strict) falls
    through to ``"auto"``/``"object"``, i.e. exactly the behavior of a
    manager without a registry, so adding one rule never silently changes
    how the *rest* of the state is checkpointed.
    """

    def __init__(self, rules: Iterable[ProviderRule] = (),
                 strict: bool = False):
        self.strict = strict
        self._rules: list = []
        self._factories: Dict[str, Callable[..., Any]] = {}
        for r in rules:
            self.add_rule(r)

    # ------------------------------------------------------------- building
    def register(self, name: str, factory: Callable[..., Any]
                 ) -> "StateProviderRegistry":
        """Register a custom tensor-provider factory under ``name``.

        The factory is called per shard as ``factory(record, **kw)`` where
        ``record`` is the :class:`~repro_torch.core.distributed.ShardRecord` and
        ``kw`` are the engine's standard
        :class:`~repro_torch.core.state_provider.TensorStateProvider` constructor
        kwargs (dtype/shape/nbytes/host_array/global_shape/index/
        chunk_bytes/device); it must return a
        ``TensorStateProvider`` (subclass) instance. Returns ``self`` for
        chaining."""
        if name in STOCK_PROVIDERS:
            raise RegistryError(
                f"cannot override stock provider {name!r}")
        if not callable(factory):
            raise RegistryError(f"factory for {name!r} is not callable")
        self._factories[name] = factory
        return self

    def add_rule(self, rule: Optional[ProviderRule] = None, /,
                 **kw) -> "StateProviderRegistry":
        """Append a rule (lowest precedence so far). Accepts a prebuilt
        :class:`ProviderRule` or its constructor kwargs. Returns ``self``."""
        if rule is None:
            rule = ProviderRule(**kw)
        elif kw:
            raise TypeError("pass a ProviderRule or kwargs, not both")
        self._rules.append(rule)
        return self

    @property
    def rules(self) -> Tuple[ProviderRule, ...]:
        return tuple(self._rules)

    @classmethod
    def default(cls) -> "StateProviderRegistry":
        """The registry equivalent of "no registry": tensors adapt to the
        save mode (raw, or delta under a DeltaPolicy), objects serialize
        lazily. Append rules *before* these catch-alls to specialize."""
        return cls(rules=[ProviderRule(provider="auto", kind="tensor"),
                          ProviderRule(provider="object", kind="object")])

    # -------------------------------------------------------------- routing
    def _serves_kind(self, provider: str, kind: str) -> bool:
        """Whether ``provider`` can serve leaves of ``kind`` (custom
        factories build tensor providers only)."""
        if provider in self._factories:
            return kind == "tensor"
        return provider in (_TENSOR_PROVIDERS if kind == "tensor"
                            else _OBJECT_PROVIDERS)

    def route(self, *, domain: str, path: str, dtype: Optional[str] = None,
              nbytes: Optional[int] = None, kind: str = "tensor"
              ) -> ProviderRoute:
        """Resolve one leaf. First matching rule wins; unmatched leaves
        fall through to the adaptive default unless ``strict``.

        A provider implies the leaf kind it serves, so a catch-all
        ``ProviderRule(provider="tensor")`` simply does not match object
        leaves (they fall through) — but a rule whose *explicit* ``kind``
        contradicts its provider is a configuration error and raises."""
        for i, rule in enumerate(self._rules):
            if not rule.matches(domain=domain, path=path, dtype=dtype,
                                nbytes=nbytes, kind=kind):
                continue
            name = rule.provider
            custom = name in self._factories
            if not custom and name not in STOCK_PROVIDERS:
                raise RegistryError(
                    f"rule #{i} routes {path!r} to unknown provider "
                    f"{name!r} — register() it or use one of "
                    f"{STOCK_PROVIDERS}")
            if not self._serves_kind(name, kind):
                if rule.kind is not None:
                    other = "tensor" if kind == "object" else "object"
                    raise RegistryError(
                        f"rule #{i} pins kind={rule.kind!r} but routes "
                        f"{path!r} to provider {name!r}, which serves "
                        f"{other} state only")
                continue  # provider-implied kind mismatch: not a match
            if name == "auto" and kind == "object":
                name = "object"
            return ProviderRoute(
                provider=name, options=rule.options, rule_index=i,
                factory=self._factories.get(name))
        if self.strict:
            raise RegistryError(
                f"no provider rule matches state path {path!r} "
                f"(domain={domain!r}, kind={kind}, dtype={dtype}, "
                f"nbytes={nbytes}) and the registry is strict — add a "
                f"matching rule or a catch-all "
                f"ProviderRule(provider='auto')")
        return ProviderRoute(provider="auto" if kind == "tensor"
                             else "object")
