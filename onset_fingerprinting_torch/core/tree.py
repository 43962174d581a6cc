"""Trees of tensors: the NamedTuples of state the port carries."""

from __future__ import annotations

import torch


def leaves(tree) -> list:
    """The tensors of a tree, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in leaves(sub)]


def write_into(out, new):
    """Copy each tensor of the tree ``new`` into the same place of ``out``
    (a tree of the same structure) and return ``out``.  A leaf that is the
    very tensor it would be copied into is left alone, so ``out`` may be
    (or share leaves with) ``new``."""
    if isinstance(out, torch.Tensor):
        if out is not new:
            out.copy_(new)
        return out
    for o, n in zip(out, new, strict=True):
        write_into(o, n)
    return out
