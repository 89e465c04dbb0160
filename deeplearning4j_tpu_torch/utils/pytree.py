"""The port's copy of `deeplearning4j_tpu/utils/pytree.py`
`tree_flatten_with_paths`, over dicts (keys sorted, as ``jax.tree_util``
flattens them), lists and tuples: the order of `models/model.py`
`tree_leaves`."""

from __future__ import annotations


def tree_flatten_with_paths(tree) -> list:
    """[(dotted.path, leaf)] in flattening order — the analog of DL4J's
    flattened param table keyed by layer / param name."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            kids = [(str(k), node[k]) for k in sorted(node)]
        elif isinstance(node, (list, tuple)):
            kids = [(str(i), v) for i, v in enumerate(node)]
        else:
            out.append((".".join(prefix), node))
            return
        for name, child in kids:
            walk(child, prefix + [name])

    walk(tree, [])
    return out
