"""Weights drawn from the seed, on the device, in the type they are served in.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference. The program gives only the shapes and dtypes
of its parameter tree (its abstract parameters, on the meta device). Each
dtype's leaves share one flat buffer, filled with standard normals by a
``torch.Generator`` on the device in a few large calls, then each leaf's
view is scaled in place by its configuration's rule (``init`` in the
configuration file: a leaf name to the configuration key whose value to
the power -1/2 is the standard deviation, a product of keys such as
"n_heads*head_dim", or "ones"; [rule, axis] also zeroes the entries of
``axis`` past ``vocab_size``, the program's padding of the vocabulary).
"""
from __future__ import annotations

import torch

_CHUNK = 1 << 28  # elements a normal_ call


def leaves(tree, path=()):
    """(path, leaf) pairs of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(meta_tree, model_cfg: dict, init: dict, seed: int, device) -> dict:
    """A tree shaped as ``meta_tree`` with every leaf drawn from ``seed``."""
    pairs = list(leaves(meta_tree))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    by_dtype: dict = {}
    for path, t in pairs:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    out: dict = {}
    for dtype, group in by_dtype.items():
        total = sum(t.numel() for _, t in group)
        flat = torch.empty(total, dtype=dtype, device=device)
        for a in range(0, total, _CHUNK):
            flat[a:a + _CHUNK].normal_(0.0, 1.0, generator=gen)
        off = 0
        for path, t in group:
            view = flat[off:off + t.numel()].view(t.shape)
            off += t.numel()
            rule = init.get(path[-1])
            if rule is None:
                raise KeyError(f"no init rule for parameter {'/'.join(path)}")
            vocab_axis = None
            if isinstance(rule, list):
                rule, vocab_axis = rule
            if rule == "ones":
                view.fill_(1.0)
            else:
                fan_in = 1
                for key in rule.split("*"):
                    fan_in *= int(model_cfg[key])
                view.mul_(float(fan_in) ** -0.5)
            if vocab_axis is not None:
                # the rows of a padded vocabulary hold zeros, as a checkpoint
                # loaded into the padded layout would
                view.narrow(vocab_axis, model_cfg["vocab_size"],
                            t.shape[vocab_axis] - model_cfg["vocab_size"]).zero_()
            _put(out, path, view)
    return out
