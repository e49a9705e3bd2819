"""Pytrees of tensors: nested dicts, lists and tuples, flattened in the
JAX package's order.

The JAX package walks its parameter, optimizer and update trees with
``jax.tree_util``; the port walks the same nesting with these functions,
which keep ``jax.tree_util``'s conventions so that both packages see the
same leaves in the same order under the same names:

* dict children in sorted key order, list and tuple children in order;
* ``None`` is an empty subtree (no leaf);
* anything else is a leaf, unless ``is_leaf`` says so first;
* :func:`keystr` names a leaf's path as ``jax.tree_util.keystr`` does,
  e.g. ``"['opt']['m']['groups'][0][0]['mix']['wq']"``.

:class:`TreeDef` records the structure as ``jax``'s ``PyTreeDef`` does: a
post-order list of nodes ``(kind, arity, keys, num_leaves, num_nodes)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

# node kinds, numbered as jax's PyTreeDef numbers them
LEAF, NONE, TUPLE, LIST, DICT = 0, 1, 2, 4, 5

IsLeaf = Optional[Callable[[Any], bool]]


@dataclass(frozen=True)
class Node:
    kind: int
    arity: int
    keys: Optional[Tuple[Any, ...]]    # sorted dict keys, else None
    num_leaves: int
    num_nodes: int


@dataclass(frozen=True)
class TreeDef:
    """The structure of a pytree: its nodes in post-order."""

    nodes: Tuple[Node, ...]

    @property
    def num_leaves(self) -> int:
        return self.nodes[-1].num_leaves if self.nodes else 0

    def unflatten(self, leaves: Sequence[Any]) -> Any:
        return unflatten(self, leaves)

    def flatten_up_to(self, tree: Any) -> List[Any]:
        """The subtrees of ``tree`` at this structure's leaf positions."""
        out: List[Any] = []
        _flatten_up_to(self.nodes, len(self.nodes) - 1, tree, out)
        return out


def _children(tree: Any) -> Tuple[int, Optional[tuple], list]:
    if tree is None:
        return NONE, None, []
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return DICT, keys, [tree[k] for k in keys]
    if isinstance(tree, list):
        return LIST, None, list(tree)
    if isinstance(tree, tuple):
        return TUPLE, None, list(tree)
    return LEAF, None, []


def _walk(tree: Any, path: Tuple[str, ...], is_leaf: IsLeaf,
          leaves: list, nodes: list) -> Node:
    if is_leaf is not None and is_leaf(tree):
        kind, keys, kids = LEAF, None, []
    else:
        kind, keys, kids = _children(tree)
    if kind == LEAF:
        leaves.append(("".join(path), tree))
        node = Node(LEAF, 0, None, 1, 1)
    else:
        n_leaves = n_nodes = 0
        labels = ([f"[{k!r}]" for k in keys] if kind == DICT
                  else [f"[{i}]" for i in range(len(kids))])
        for label, kid in zip(labels, kids):
            sub = _walk(kid, path + (label,), is_leaf, leaves, nodes)
            n_leaves += sub.num_leaves
            n_nodes += sub.num_nodes
        node = Node(kind, len(kids), keys, n_leaves, n_nodes + 1)
    nodes.append(node)
    return node


def flatten_with_path(tree: Any, is_leaf: IsLeaf = None
                      ) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr of the path, leaf)], treedef)``, leaves in order."""
    leaves: list = []
    nodes: list = []
    _walk(tree, (), is_leaf, leaves, nodes)
    return leaves, TreeDef(tuple(nodes))


def flatten(tree: Any, is_leaf: IsLeaf = None) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def _build(nodes: Sequence[Node], leaves: Sequence[Any]) -> Any:
    stack: list = []
    it = iter(leaves)
    for node in nodes:
        if node.kind == LEAF:
            stack.append(next(it))
            continue
        kids = stack[len(stack) - node.arity:] if node.arity else []
        del stack[len(stack) - node.arity:]
        if node.kind == NONE:
            stack.append(None)
        elif node.kind == DICT:
            stack.append(dict(zip(node.keys, kids)))
        elif node.kind == LIST:
            stack.append(list(kids))
        elif node.kind == TUPLE:
            stack.append(tuple(kids))
        else:
            raise ValueError(f"unknown node kind {node.kind}")
    if len(stack) != 1:
        raise ValueError("malformed tree structure")
    return stack[0]


def unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a structure of "
                         f"{treedef.num_leaves}")
    return _build(treedef.nodes, leaves)


def _flatten_up_to(nodes, at: int, tree: Any, out: list) -> int:
    """Collect ``tree``'s subtrees at the leaves of the subtree rooted at
    node ``at``; returns the index just before that subtree's first
    node."""
    node = nodes[at]
    if node.kind == LEAF:
        out.append(tree)
        return at - 1
    kind, keys, kids = _children(tree)
    if kind != node.kind or len(kids) != node.arity or (
            kind == DICT and keys != node.keys):
        raise ValueError("tree does not match the structure")
    # children sit right before their parent, last child last
    starts, j = [], at - 1
    for _ in range(node.arity):
        starts.append(j)
        j -= nodes[j].num_nodes
    for kid, start in zip(kids, reversed(starts)):
        sub: list = []
        _flatten_up_to(nodes, start, kid, sub)
        out.extend(sub)
    return j


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None
             ) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of
    ``rest``), keeping the structure."""
    flat, treedef = flatten(tree, is_leaf)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(flat, *others)])
