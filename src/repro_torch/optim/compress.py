"""Int8 gradient compression with error feedback (the reference's
``optim/compress.py``).

Each leaf is quantized to int8 with one f32 scale, max|g| / 127, and the
quantization residual is returned as the next step's error feedback.  The
max is exact, and the division and the round-half-even are correctly
rounded on both sides, so the port's ``q`` and scales equal the
reference's bit for bit.  The train step uses it only across a pod axis
(``launch/steps.py``).  On DTensor gradients each rank quantizes its own
shard with the leaf's global scale (the max reduced over the mesh), so
``q`` keeps the gradient's placements and equals the unsharded ``q``
element for element; the scale is a plain () tensor, equal on every
rank.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import like, local, mesh_reduce, tree_map


def compress_grads_int8(grads, error=None) -> Tuple[Any, Any, Any]:
    """Returns (q_int8_tree, scale_tree, new_error_tree)."""
    if error is None:
        error = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                         grads)

    def one(g0, e):
        g = local(g0).float() + local(e)
        s = torch.clamp(mesh_reduce(torch.max(torch.abs(g)), g0, "max"),
                        min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        return like(q, g0), s, like(g - q.float() * s, g0)

    out = tree_map(one, grads, error)          # (q, s, e) at each leaf
    return tuple(tree_map(lambda _, o: o[i], grads, out) for i in range(3))


def decompress_grads_int8(q, s):
    return tree_map(lambda qi, si: like(local(qi).float() * si, qi), q, s)
