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
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(``/``-joined key path, leaf) of a nested dict's leaves, in key
    order: the names ``checkpoint.export_npz`` writes."""
    if isinstance(tree, dict):
        return [item for key in tree for item in tree_items(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def check_layout(what: str, have: dict, got: dict) -> None:
    """Raise ValueError naming the keys (or shapes) of ``got`` that differ
    from ``have``'s."""
    if have == got:
        return
    missing, extra = sorted(set(have) - set(got)), sorted(set(got) - set(have))
    shapes = sorted(k for k in set(have) & set(got) if have[k] != got[k])
    raise ValueError(f"{what} of another tree layout: missing {missing[:6]}, unexpected "
                     f"{extra[:6]}, other shapes {shapes[:6]}")


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
        items = tree_items(params)
        self.names = [name for name, _ in items]
        self.leaves = [t.requires_grad_(True) for _, t in items]
        kw = dict(lr=opt.learning_rate(0), betas=(opt.b1, opt.b2), eps=opt.eps)
        self.torch_opt = (torch.optim.AdamW(self.leaves, weight_decay=opt.weight_decay, **kw)
                          if opt.weight_decay else torch.optim.Adam(self.leaves, **kw))
        self.count = 0
        self.sq_sum = None     # the clip's squared norm on a sharded tree (mesh steps set it)

    def _shapes(self) -> dict[str, list[int]]:
        return {name: list(t.shape) for name, t in zip(self.names, self.leaves)}

    def state_dict(self) -> dict:
        """The updates applied so far (``count``, which the schedule reads)
        and, by leaf name, Adam's moments and step, copied to the host; a
        leaf that never had a gradient has no moments. ``shapes`` is the
        tree's layout, which ``load_state_dict`` checks."""
        moments = self.torch_opt.state_dict()["state"]
        return {"count": self.count, "shapes": self._shapes(),
                "leaves": {self.names[i]: {k: v.detach().to("cpu", copy=True)
                                           for k, v in st.items()}
                           for i, st in moments.items()}}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s moments, steps and count (the moments
        onto their leaves' device); a state of another tree layout raises
        ValueError naming the keys that differ."""
        if "shapes" not in state:
            raise ValueError(f"optimizer state of groups {sorted(state.get('groups', {}))}, "
                             "want one group")
        check_layout("optimizer state", self._shapes(), state["shapes"])
        sd = self.torch_opt.state_dict()
        index = {name: i for i, name in enumerate(self.names)}
        sd["state"] = {index[name]: dict(st) for name, st in state["leaves"].items()}
        self.torch_opt.load_state_dict(sd)
        self.count = int(state["count"])

    def apply(self) -> None:
        """Clip, step at the scheduled lr, and clear the gradients."""
        clip_by_global_norm(self.leaves, self.opt.grad_clip, self.sq_sum)
        for group in self.torch_opt.param_groups:
            group["lr"] = self.opt.learning_rate(self.count)
        self.torch_opt.step()
        self.torch_opt.zero_grad(set_to_none=True)
        self.count += 1


def clip_by_global_norm(leaves: list[torch.Tensor], max_norm: float, sq_sum=None) -> None:
    """Scale the leaves' gradients in place by max_norm / norm when their
    global L2 norm reaches max_norm (optax: no epsilon); 0 turns it off.
    ``sq_sum(leaves)``, where given, is the squared norm (a tree sharded
    over a mesh's model axis: ``parallel/sharding.sharded_sq_sum``)."""
    grads = [t.grad for t in leaves if t.grad is not None]
    if max_norm and grads:
        total = (sq_sum(leaves) if sq_sum is not None
                 else sum(g.float().square().sum() for g in grads))
        norm = torch.sqrt(total)
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
        self.sq_sum = None

    def state_dict(self) -> dict:
        """One ``OptState.state_dict()`` per group."""
        return {"groups": {k: s.state_dict() for k, s in self.states.items()}}

    def load_state_dict(self, state: dict) -> None:
        """Each group's state; a state of other groups (or a one-group
        state) raises ValueError naming them."""
        groups = state.get("groups")
        if groups is None or set(groups) != set(self.states):
            raise ValueError(f"optimizer state of groups "
                             f"{sorted(groups) if groups is not None else 'none (one group)'}, "
                             f"want {sorted(self.states)}")
        for k, s in self.states.items():
            s.load_state_dict(groups[k])

    def apply(self) -> None:
        """Clip the whole tree, then step each group and clear its gradients."""
        clip_by_global_norm(self.leaves, self.opt.grad_clip, self.sq_sum)
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
