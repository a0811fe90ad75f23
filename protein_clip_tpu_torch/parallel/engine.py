"""The mesh engine behind the training CLIs: the port of
``protein_clip_tpu/parallel/engine.py`` (its data axis).

``train/loop.fit`` drives any engine with ``make_optimizer``,
``make_train_step`` and ``make_eval_step`` (the single-device engines'
signatures) and, where it has one, ``make_prepare``. ``MeshEngine`` routes
an (arch, mode, packed) composition to the sharded step factories
(``step.py`` for CLIP; ``filip_step.py``, ``packed_step.py`` and
``filip_finetune_step.py`` for FILIP) and builds the sharded eval steps.
``make_prepare`` gives each rank its part of the batch every rank tokenizes
alike from the seeded loaders: its rows of the padded wire, or its shard of
the packed one.

The data axis replicates the model, so the TPU engine's model-state
placement (``prepare_esm``, ``prepare_params``, ``export_view``) has nothing
to do here; it comes with a 'model' axis (tensor parallelism) or pipeline
stages, which raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable

from ..train import finetune, lora, optimizer as opt_mod
from ..train.clip_engine import EngineConfig, tokenize_pair_batch
from . import filip_step, packed_step, step as step_mod
from .filip_finetune_step import make_sharded_filip_finetune_step
from .mesh import make_mesh


def _filip_view(mode: str, cfg: EngineConfig) -> Callable:
    """(params, esm_params) -> (head params, backbone params) of a mode, for
    the FILIP eval steps."""
    if mode == "frozen":
        return lambda p, e: (p, e)
    backbone = finetune.esm_view(cfg) if mode == "finetune" else lora.esm_view(cfg)
    return lambda p, e: (p["heads"], backbone(p, e))


class MeshEngine:
    """``loop.fit``'s engine protocol over the sharded step factories.
    arch: "clip" | "filip"; mode: "frozen" | "finetune" | "lora"; packed:
    flat packing (``packed_step.tokenize_packed_sharded``)."""

    def __init__(self, *, data: int = 1, model: int = 1, stages: int = 1, arch: str = "clip",
                 mode: str = "frozen", packed: bool = False):
        if arch not in ("clip", "filip"):
            raise ValueError(f"unknown arch {arch!r}")
        if mode not in ("frozen", "finetune", "lora"):
            raise ValueError(f"unknown mode {mode!r}")
        if stages > 1:
            raise NotImplementedError(
                f"not ported yet: {stages} pipeline stages (--pp): multi-device training "
                "beyond the data axis (ROADMAP queue 1: multi-device, PP)")
        self.mesh = make_mesh(data=data, model=model)
        self.arch, self.mode, self.packed = arch, mode, packed

    def make_optimizer(self, cfg: EngineConfig):
        if self.mode == "finetune":
            return finetune.make_optimizer(cfg)
        if self.mode == "lora":
            return lora.make_optimizer(cfg)
        return opt_mod.from_config(cfg)

    def make_train_step(self, cfg: EngineConfig):
        mesh = self.mesh
        if self.arch == "clip":
            return step_mod.make_sharded_train_step(cfg, mesh, self.mode, self.packed)
        if self.mode != "frozen":
            return make_sharded_filip_finetune_step(cfg, mesh, packed=self.packed,
                                                    lora_view=self.mode == "lora")
        if self.packed:
            return packed_step.make_sharded_packed_filip_step(cfg, mesh)
        return filip_step.make_sharded_filip_train_step(cfg, mesh)

    def make_eval_step(self, cfg: EngineConfig):
        if self.arch == "clip":
            return step_mod.make_sharded_eval_step(cfg, self.mesh, self.mode, self.packed)
        view = _filip_view(self.mode, cfg)
        if self.packed:
            return packed_step.make_sharded_packed_filip_eval_step(cfg, self.mesh, view)
        return filip_step.make_sharded_filip_eval_step(cfg, self.mesh, view)

    def make_prepare(self, cfg: EngineConfig, tokenizer) -> Callable:
        """(peps, recs) of the global batch -> this rank's host batch: its
        rows of ``tokenize_pair_batch``'s padded wire (the widths are the
        global batch's, so every rank's tokens gather), or its shard of
        ``tokenize_packed_sharded``'s."""
        n, index = self.mesh.data, self.mesh.index
        if self.packed:
            def prepare(peps, recs):
                return packed_step.shard_of(
                    packed_step.tokenize_packed_sharded(tokenizer, peps, recs, n), index)
            return prepare

        def prepare(peps, recs):
            if len(peps) % n:
                raise ValueError(f"batch {len(peps)} not divisible by data axis {n}")
            b = len(peps) // n
            return {k: v[index * b:(index + 1) * b].contiguous()
                    for k, v in tokenize_pair_batch(tokenizer, peps, recs).items()}
        return prepare
