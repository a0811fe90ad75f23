"""Optimizer factory: the port of ``protein_clip_tpu/train/optimizer.py``.

Adam (the reference's lr 1e-3, betas (0.9, 0.999), eps 1e-8) or, with
weight decay, AdamW, under a constant, linear-warmup or warmup+cosine
learning-rate schedule, with an optional clip to a global L2 norm. The
numbers follow optax's formulas, which the TPU package uses, not PyTorch's
near-equivalents:

- the schedule is read at the count of updates applied so far, so with
  warmup the first update runs at lr(0) = 0;
- ``warmup_cosine_decay_schedule`` counts its ``decay_steps`` (the run's
  total) from step 0, warmup included;
- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6).

``torch.optim.Adam`` and ``AdamW`` compute optax's ``adam`` and ``adamw``
updates (decoupled decay scaled by the scheduled lr). The parameters are
updated in place: the TPU package returns new arrays instead.

``multi_transform`` is the counterpart of ``optax.multi_transform`` over the
top-level groups of a parameter tree (backbone or adapters, and heads), each
group with its own ``Optimizer``; its ``grad_clip`` clips by the norm of the
whole tree before either group steps, as ``optax.chain(clip_by_global_norm,
multi_transform)`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    return [tree]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam/AdamW with a schedule and an optional global-norm clip. ``init``
    binds it to a parameter tree."""

    lr: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 0
    schedule: str = "constant"
    total_steps: int | None = None
    grad_clip: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        if self.schedule == "cosine":
            if not self.total_steps:
                raise ValueError("cosine schedule needs total_steps (the optimizer-step horizon)")
            if self.total_steps - self.warmup_steps <= 0:
                raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got "
                                 f"{self.total_steps} and {self.warmup_steps}")
        elif self.schedule != "constant":
            raise ValueError(f"unknown lr schedule {self.schedule!r}")

    def learning_rate(self, count: int) -> float:
        """optax's schedule value after ``count`` updates: linear warmup from
        0 over ``warmup_steps``, then flat or a cosine decay to 0 at
        ``total_steps``."""
        w = self.warmup_steps
        if w > 0 and count < w:
            return self.lr * count / w
        if self.schedule == "constant":
            return self.lr
        decay = self.total_steps - w
        t = min(count - w, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def init(self, params) -> "OptState":
        return OptState(self, params)


class OptState:
    """The optimizer bound to a parameter tree: the tree's tensors become
    trainable leaves, and ``apply`` turns their ``.grad`` into one update."""

    def __init__(self, opt: Optimizer, params):
        self.opt = opt
        self.leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        kw = dict(lr=opt.learning_rate(0), betas=(opt.b1, opt.b2), eps=opt.eps)
        self.torch_opt = (torch.optim.AdamW(self.leaves, weight_decay=opt.weight_decay, **kw)
                          if opt.weight_decay else torch.optim.Adam(self.leaves, **kw))
        self.count = 0

    def apply(self) -> None:
        """Clip, step at the scheduled lr, and clear the gradients."""
        clip_by_global_norm(self.leaves, self.opt.grad_clip)
        for group in self.torch_opt.param_groups:
            group["lr"] = self.opt.learning_rate(self.count)
        self.torch_opt.step()
        self.torch_opt.zero_grad(set_to_none=True)
        self.count += 1


def clip_by_global_norm(leaves: list[torch.Tensor], max_norm: float) -> None:
    """Scale the leaves' gradients in place by max_norm / norm when their
    global L2 norm reaches max_norm (optax: no epsilon); 0 turns it off."""
    grads = [t.grad for t in leaves if t.grad is not None]
    if max_norm and grads:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))


@dataclasses.dataclass(frozen=True)
class MultiOptimizer:
    """One ``Optimizer`` per top-level group of the parameter tree, and a
    clip by the whole tree's global norm ahead of them."""

    groups: dict[str, Optimizer]
    grad_clip: float = 0.0

    def init(self, params) -> "MultiOptState":
        return MultiOptState(self, params)


class MultiOptState:
    """``MultiOptimizer`` bound to a tree: one ``OptState`` per group."""

    def __init__(self, opt: MultiOptimizer, params):
        if set(params) != set(opt.groups):
            raise ValueError(f"parameter groups {sorted(params)} != optimizer groups "
                             f"{sorted(opt.groups)}")
        self.opt = opt
        self.states = {k: o.init(params[k]) for k, o in opt.groups.items()}
        self.leaves = [t for s in self.states.values() for t in s.leaves]

    def apply(self) -> None:
        """Clip the whole tree, then step each group and clear its gradients."""
        clip_by_global_norm(self.leaves, self.opt.grad_clip)
        for state in self.states.values():
            state.apply()


def multi_transform(groups: dict[str, Optimizer], grad_clip: float = 0.0) -> MultiOptimizer:
    """Two-group (or more) training: the whole tree is clipped once, before
    the groups step, so each group's own grad_clip stays 0."""
    return MultiOptimizer(dict(groups), grad_clip)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return Optimizer(lr=lr, b1=b1, b2=b2, eps=eps)


def build(lr: float, *, weight_decay: float = 0.0, warmup_steps: int = 0,
          schedule: str = "constant", total_steps: int | None = None,
          grad_clip: float = 0.0, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> Optimizer:
    """Adam/AdamW with an optional warmup or warmup+cosine schedule;
    ``grad_clip`` > 0 clips to that global L2 norm before the moments see
    the gradient."""
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                     schedule=schedule, total_steps=total_steps, grad_clip=grad_clip,
                     b1=b1, b2=b2, eps=eps)


def from_config(cfg, lr: float | None = None, *, grad_clip: float | None = None) -> Optimizer:
    """The optimizer of an ``EngineConfig``'s trainer knobs."""
    return build(lr if lr is not None else cfg.learning_rate,
                 weight_decay=cfg.weight_decay, warmup_steps=cfg.warmup_steps,
                 schedule=cfg.lr_schedule, total_steps=cfg.total_steps,
                 grad_clip=cfg.grad_clip if grad_clip is None else grad_clip)
