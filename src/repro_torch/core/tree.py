"""Parameter trees without ``jax.tree_util``: flatten, unflatten and key paths.

A tree is nested ``dict`` / ``tuple`` / ``list`` / named-tuple containers
whose leaves are tensors or arrays; ``None`` is an empty node. Flattening reproduces JAX's
order exactly (dict keys sorted, sequences by index, empty containers give no
leaves) and each leaf's key is spelled as ``jax.tree_util.keystr`` spells it
(``['unit'][0]['attn']['wq']``; a named tuple's field as ``.k_pos``), so a
page table built by either package
names the same leaves in the same order. ``str(TreeDef)`` prints the same text
as JAX's ``PyTreeDef`` and :meth:`TreeDef.from_repr` parses it back, so an
image written by the JAX package restores here with its own structure.
"""
from __future__ import annotations

import ast
from typing import Any, Callable, List, Tuple

LEAF = ...   # placeholder for a leaf inside a TreeDef's skeleton


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _rebuild(node: Any, kids) -> Any:
    """A container of ``node``'s type holding ``kids`` (a named tuple takes
    them as positional fields)."""
    return type(node)(*kids) if _is_namedtuple(node) else type(node)(kids)


def _children(node: Any):
    """(key token, child) pairs of a container in JAX's flatten order."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_keys(tree: Any) -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in JAX's tree-flatten order."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, prefix: str) -> None:
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for tok, child in kids:
            walk(child, prefix + tok)

    walk(tree, "")
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``jax.tree_util.tree_map_with_path``: ``fn(keystr, leaf, *others)`` on
    every leaf, the others taken from ``rest`` trees of the same structure;
    returns a tree of the results with ``tree``'s containers."""
    def walk(node: Any, others: Tuple[Any, ...], prefix: str) -> Any:
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return fn(prefix, node, *others)
        if isinstance(node, dict):
            return {k: walk(node[k], tuple(o[k] for o in others), prefix + f"[{k!r}]")
                    for k in sorted(node)}
        return _rebuild(node, [walk(c, tuple(o[i] for o in others), prefix + tok)
                               for i, (tok, c) in enumerate(kids)])
    return walk(tree, rest, "")


class TreeDef:
    """The structure of a tree: its containers with every leaf replaced by
    :data:`LEAF`."""

    def __init__(self, skeleton: Any):
        self.skeleton = skeleton

    @classmethod
    def of(cls, tree: Any) -> "TreeDef":
        def strip(node: Any) -> Any:
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: strip(v) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return _rebuild(node, [strip(c) for c in node])
            return LEAF
        return cls(strip(tree))

    @classmethod
    def from_repr(cls, text: str) -> "TreeDef":
        """Parse ``str(treedef)`` of either package (``PyTreeDef({...})``)."""
        body = text.strip()
        if body.startswith("PyTreeDef(") and body.endswith(")"):
            body = body[len("PyTreeDef("):-1]
        out, quote = [], None
        for ch in body:                       # '*' outside string literals = leaf
            if quote:
                quote = None if ch == quote else quote
            elif ch in "'\"":
                quote = ch
            elif ch == "*":
                out.append("...")
                continue
            out.append(ch)
        return cls(ast.literal_eval("".join(out)))

    def unflatten(self, leaf_values: List[Any]) -> Any:
        it = iter(leaf_values)

        def build(node: Any) -> Any:
            if node is LEAF:
                return next(it)
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            return _rebuild(node, [build(c) for c in node])

        tree = build(self.skeleton)
        if next(it, LEAF) is not LEAF:
            raise ValueError("more leaves than the tree structure holds")
        return tree

    def __str__(self) -> str:
        def show(node: Any) -> str:
            if node is LEAF:
                return "*"
            if node is None:
                return "None"
            if isinstance(node, dict):
                return "{" + ", ".join(f"{k!r}: {show(node[k])}"
                                       for k in sorted(node)) + "}"
            inner = ", ".join(show(c) for c in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return f"PyTreeDef({show(self.skeleton)})"

    __repr__ = __str__


def nest(flat: dict) -> Any:
    """Rebuild a nested tree from ``{keystr: leaf}``.

    Integer tokens (``[0]``) become tuple positions, string tokens dict keys.
    Containers with no leaves (JAX's empty ``rem`` tuple) cannot be recovered
    from keys alone and are absent from the result.
    """
    root: dict = {}
    for key, leaf in flat.items():
        toks = [ast.literal_eval(t) for t in key[1:-1].split("][")] if key else []
        if not toks:
            raise ValueError("a bare leaf has no key path to nest")
        node = root
        for tok in toks[:-1]:
            node = node.setdefault(tok, {})
        node[toks[-1]] = leaf

    def seal(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return tuple(seal(node[i]) for i in range(len(node)))
        return {k: seal(v) for k, v in node.items()}

    return seal(root)
