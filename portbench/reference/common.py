"""Pieces the plain references share: trees, norms, the loss, AdamW."""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .precision import Precision


def flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a tree of dicts and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, fn) for v in tree)
    return fn(tree)


class Draw:
    """The benchmark's weights, drawn on ``device`` from a seed with one
    ``torch.Generator``, in the layout and the dtypes the port serves and
    trains them in: bf16 products and embeddings, each a normal draw in
    f32 scaled by its fan-in's -1/2 power (or a given scale) and cast;
    f32 norm gains and the recurrences' constants.  A family's ``init``
    draws its leaves in the port's order, so the program and the
    reference get the same numbers from the same seed."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = self.gen.device

    def normal(self, shape: Tuple[int, ...], scale: float,
               dtype=torch.bfloat16) -> torch.Tensor:
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (w * scale).to(dtype)

    def dense(self, d_in: int, d_out: int, lead: Tuple[int, ...] = (),
              scale: float = 0.0, dtype=torch.bfloat16) -> Dict:
        return {"w": self.normal(lead + (d_in, d_out),
                                 scale or d_in ** -0.5, dtype)}

    def full(self, shape: Tuple[int, ...], value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)

    def norm(self, d: int, lead: Tuple[int, ...] = ()) -> Dict:
        return {"g": self.full(lead + (d,), 1.0)}


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} over the sequence (B, S, D), zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _nll_sum(h, head, labels, mask, prec: Precision):
    logits = prec.mm(h, head)
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - pick) * mask).sum()


def masked_xent(h: torch.Tensor, head: torch.Tensor, labels, mask,
                prec: Precision, chunk: int = 1024) -> torch.Tensor:
    """Mean masked next-token cross-entropy of hidden states h (B, S, D)
    against ``head`` (D, V), the logits made a chunk of positions at a
    time and recomputed in the backward."""
    total = h.new_zeros(())
    for a in range(0, h.shape[1], chunk):
        sl = slice(a, a + chunk)
        args = (h[:, sl], head, labels[:, sl], mask[:, sl], prec)
        total = total + (checkpoint(_nll_sum, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _nll_sum(*args))
    return total / torch.clamp(mask.sum(), min=1.0)


_SLICE = 1 << 26


def slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` a run of its leading axis at a time (at most
    ``_SLICE`` elements, or one row), so temporaries stay small."""
    if t.dim() == 0 or t.numel() <= _SLICE:
        yield t
        return
    rows = max(1, _SLICE // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield t[i:i + rows]


def sq_sum(t: torch.Tensor) -> float:
    """sum(t^2), accumulated in f64 a slice at a time."""
    return sum(float(torch.sum(s.double() ** 2)) for s in slices(t))


def leaf_norm(t: torch.Tensor) -> float:
    return math.sqrt(sq_sum(t))


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in f64, a slice of the leading axis at a time (b may lie
    on another device)."""
    return math.sqrt(sum(
        float(torch.sum((x.double() - y.to(x.device).double()) ** 2))
        for x, y in zip(slices(a), slices(b))))


class AdamW:
    """AdamW with global-norm clipping in f32 (Loshchilov & Hutter; the
    port's hyperparameters: b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1
    on every leaf, the gradient clipped to global norm 1).  The moments
    live on the host, a leaf at a time on the device while it updates."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.clip = clip_norm
        self.t = 0
        self.m: List = [None] * len(params)
        self.v: List = [None] * len(params)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             last: bool = False) -> Tuple[float, float]:
        """Updates the params in place; returns (global norm, clip scale).
        After the ``last`` step the moments are not kept."""
        gnorm = math.sqrt(sum(sq_sum(g) for g in grads))
        scale = min(1.0, self.clip / max(gnorm, 1e-12))
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for i, (p, g) in enumerate(zip(self.params, grads)):
            m, v = ((torch.zeros_like(p), torch.zeros_like(p))
                    if self.m[i] is None else
                    (self.m[i].to(p.device), self.v[i].to(p.device)))
            for ps, gs, ms, vs in zip(slices(p), slices(g), slices(m),
                                      slices(v)):
                gs = gs * scale
                ms.mul_(self.b1).add_(gs, alpha=1.0 - self.b1)
                vs.mul_(self.b2).add_(gs * gs, alpha=1.0 - self.b2)
                u = (ms / bc1) / (torch.sqrt(vs / bc2) + self.eps)
                ps.sub_(self.lr * (u + self.wd * ps))
            self.m[i], self.v[i] = ((None, None) if last
                                    else (m.cpu(), v.cpu()))
        return gnorm, scale


def train_steps(params_tree, loss_fn, batches: Iterator[Dict], lr: float,
                n_steps: int) -> Dict:
    """``n_steps`` AdamW steps of ``loss_fn(params_tree, batch)`` from the
    f32 leaves of ``params_tree`` (updated in place).  Returns the loss of
    each step, each leaf's norm of the first gradient after clipping, the
    global norm of the first gradient, and each leaf's norm of its change
    over the steps."""
    named = flatten(params_tree)
    names = [n for n, _ in named]
    leaves = [p for _, p in named]
    start = [p.detach().cpu().clone() for p in leaves]
    opt = AdamW(leaves, lr)
    losses, grad0, gnorm0 = [], None, None
    for s in range(n_steps):
        batch = next(batches)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params_tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(leaves, grads)]
        losses.append(float(loss.detach()))
        del loss
        for p in leaves:
            p.requires_grad_(False)
        gnorm, scale = opt.step(grads, last=s == n_steps - 1)
        if s == 0:
            grad0 = {n: leaf_norm(g) * scale for n, g in zip(names, grads)}
            gnorm0 = gnorm
        del grads
    change = {n: diff_norm(p.detach(), p0)
              for n, p, p0 in zip(names, leaves, start)}
    return {"losses": losses, "grad0": grad0, "gnorm0": gnorm0,
            "change": change}
