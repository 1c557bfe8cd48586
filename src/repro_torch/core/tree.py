"""A small pytree flatten that walks state as ``jax.tree_util`` does.

Dicts are walked in sorted key order, lists and tuples by index, a
namedtuple by field, and ``None`` holds no leaf; everything else is a
leaf. Paths render exactly as ``repro.core.distributed._path_str`` renders
JAX key paths (``model/groups/0/0/attn/wq``), and :func:`keystr` exactly as
``jax.tree_util.keystr`` does (``['groups'][0][0]['attn']['wq']``), so
tensor names, leaf order and therefore files agree between the two
packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


class AttrKey(str):
    """A namedtuple field in a path: a ``str`` (``path_str`` prints it as
    the field name) that :func:`keystr` renders as ``.field``, where a
    dict key renders as ``['field']``."""


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[Path, Any]],
                                          Callable[[List[Any]], Any]]:
    """``([(path, leaf), ...], unflatten)``; ``unflatten(leaves)`` rebuilds
    a tree of the same structure from leaves in the same order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node: Any, path: Path) -> Callable[[List[Any]], Any]:
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [walk(node[k], path + (k,)) for k in keys]
            kind = type(node)
            return lambda it: kind(
                (k, f(it)) for k, f in zip(keys, subs))
        if _is_namedtuple(node):
            subs = [walk(getattr(node, f), path + (AttrKey(f),))
                    for f in node._fields]
            kind = type(node)
            return lambda it: kind(*[f(it) for f in subs])
        if isinstance(node, (list, tuple)):
            subs = [walk(v, path + (i,)) for i, v in enumerate(node)]
            kind = type(node)
            return lambda it: kind(f(it) for f in subs)
        out.append((path, node))
        return lambda it: next(it)

    build = walk(tree, ())

    def unflatten(leaves: List[Any]) -> Any:
        it = iter(leaves)
        return build(it)

    return out, unflatten


def path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of the same path: ``[key!r]`` for a dict
    key, ``[i]`` for a list or tuple index, ``.name`` for a namedtuple
    field."""
    return "".join(f".{p}" if isinstance(p, AttrKey) else f"[{p!r}]"
                   for p in path)


def leaves(tree: Any) -> List[Any]:
    return [leaf for _p, leaf in flatten_with_path(tree)[0]]


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    flat, unflatten = flatten_with_path(tree)
    return unflatten([fn(leaf) for _p, leaf in flat])
