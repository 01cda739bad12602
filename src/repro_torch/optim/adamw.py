"""AdamW with global-norm clipping (the reference's ``optim/adamw.py``).

Moments are f32 trees shaped like the parameters, 8 bytes a parameter.
Unlike the reference, whose update returns new arrays, the port updates
the parameters and the moments in place under ``torch.no_grad()``: at 3B
parameters a second copy of both does not fit beside the activations on
one 80 GB card.  Large leaves are updated a slice of their leading axis
at a time, so the f32 temporaries stay small.  The arithmetic is the
reference's, in its order: ``scale = min(1, clip / max(gnorm, 1e-12))``,
the bias corrections ``1 - b**t`` in f32, ``u = (m / bc1) / (sqrt(v /
bc2) + eps) + wd·p`` and ``p - lr·u`` in f32, cast to ``p``'s dtype.
Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import Any, Iterator, NamedTuple, Tuple

import torch

from .tree import leaves, tree_map

# elements a slice of a leaf's leading axis may hold in one update
_SLICE = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step, zeros, tree_map(torch.clone, zeros))


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Views of ``ts`` (one shape) a run of their leading axis at a time,
    each of at most ``_SLICE`` elements (a whole row if one is larger)."""
    t0 = ts[0]
    if t0.dim() == 0 or t0.numel() <= _SLICE:
        yield ts
        return
    rows = max(1, _SLICE // max(1, t0[0].numel()))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g²) in f32, a () tensor."""
    total = None
    for g in leaves(tree):
        for (gs,) in _slices(g):
            s = torch.sum(torch.square(gs.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One step: ``params``, ``state.m`` and ``state.v`` are updated in
    place and returned with the new step and the gradients' global norm
    (before clipping), as the reference returns them."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        for ps, gs, ms, vs in _slices(p, g, m, v):
            gf = gs.float() * scale
            ms.mul_(b1).add_(gf * (1.0 - b1))
            vs.mul_(b2).add_(gf.square_().mul_(1.0 - b2))
            u = (ms / bc1).div_((vs / bc2).sqrt_().add_(eps))
            pf = ps.float()
            u.add_(pf * weight_decay)
            if pf is ps:               # f32 leaf: the update lands in p
                ps.sub_(u.mul_(lr))
            else:
                ps.copy_(pf.sub_(u.mul_(lr)))
    return params, AdamWState(step, state.m, state.v), gnorm
