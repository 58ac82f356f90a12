"""AdamW with global-norm clipping and a warmup-cosine schedule (a port of
the reference's ``training/optimizer.py``).

The reference's function, not ``torch.optim.AdamW``: decoupled decay on
tensors of two or more dimensions only (norms and biases excluded),
clipping by the global norm of every gradient, bias correction, float32
moments whatever the parameter dtype, the update computed in float32 and
cast back to each parameter's dtype. Parameters and gradients are trees
(nested dicts, lists and tuples of tensors); a tensor that sits in the tree
more than once (Zamba2's shared attention block) is one parameter. The
port updates the parameters and the moments in place (the reference
returns new arrays and donates the old ones), which keeps a full-width
step from holding two copies of the float32 moments.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int
    m: Any
    v: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure; a node that appears more than once
    maps to one result, so shared blocks stay shared."""
    memo: Dict[int, Any] = {}

    def go(node, *others):
        key = id(node)
        if key in memo:
            return memo[key]
        if isinstance(node, dict):
            out = {k: go(v, *(o[k] for o in others))
                   for k, v in node.items()}
        elif isinstance(node, (list, tuple)):
            items = [go(v, *(o[i] for o in others))
                     for i, v in enumerate(node)]
            out = (type(node)(*items) if hasattr(node, "_fields")
                   else type(node)(items))
        elif node is None:
            out = None
        else:
            out = fn(node, *others)
        memo[key] = out
        return out

    return go(tree, *rest)


def leaves(tree) -> List[torch.Tensor]:
    """The distinct tensors of a tree, in traversal order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def init_opt_state(params) -> OptState:
    """Zero moments in float32, laid out as their parameters (a DTensor
    parameter's moments are DTensors of its placements)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(step=0, m=tree_map(zeros, params),
                    v=tree_map(zeros, params))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine down to
    ``min_lr_ratio`` of ``lr``; float32, as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, state, metrics) with the
    parameters and moments updated in place. ``metrics`` holds the
    pre-clip ``grad_norm`` and the step's ``lr``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = float(schedule(cfg, step))
    b1, b2 = cfg.betas
    bc1 = float(1.0 - _f32(b1) ** _f32(step))
    bc2 = float(1.0 - _f32(b2) ** _f32(step))

    def upd(p, g, m, v):
        g = g.float() * scale.to(g.device)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:          # decay matrices only (norms, biases not)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, state.m, state.v)
    return params, OptState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
