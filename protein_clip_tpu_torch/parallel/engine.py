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

The model-state placement is the TPU engine's: with a 'model' axis
(tensor parallelism) ``prepare_esm`` cuts the frozen backbone (frozen and
LoRA modes) and ``prepare_params`` the finetune engine's f32 masters to the
rank's Megatron slices (``sharding.shard_params``), so the optimizer's
moments are born sharded; ``export_view`` (and ``export_esm``,
``export_opt_state``) gather them back to the one-device layout for
``best_model.npz``, the train-state snapshots and the figures, and
``prepare_params`` / ``shard_opt_state`` cut a restored snapshot again. On the
data axis alone they change nothing. Packed steps refuse a model axis, as
the TPU package's do; pipeline stages raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable

from ..train import finetune, lora, optimizer as opt_mod
from ..train.clip_engine import EngineConfig, tokenize_pair_batch
from . import filip_step, packed_step, sharding, step as step_mod
from .filip_finetune_step import make_sharded_filip_finetune_step
from .mesh import make_mesh

# the TPU package's refusal of a packed mesh with a model axis
PACKED_TP = ("--packed sharding is DP-only (the fused attention custom call cannot split over "
             "a 'model' axis); compose --tp via the unpacked path")


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
    flat packing (``packed_step.tokenize_packed_sharded``); ``esm``, the
    backbone's config, is checked against the model axis."""

    def __init__(self, *, data: int = 1, model: int = 1, stages: int = 1, arch: str = "clip",
                 mode: str = "frozen", packed: bool = False, esm=None):
        if arch not in ("clip", "filip"):
            raise ValueError(f"unknown arch {arch!r}")
        if mode not in ("frozen", "finetune", "lora"):
            raise ValueError(f"unknown mode {mode!r}")
        if stages > 1:
            raise NotImplementedError(
                f"not ported yet: {stages} pipeline stages (--pp): multi-device training "
                "beyond the data and model axes (ROADMAP queue 1: multi-device, PP)")
        if packed and model > 1:
            raise ValueError(PACKED_TP)
        self.mesh = make_mesh(data=data, model=model, esm_cfg=esm)
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
        view = _filip_view(self.mode, step_mod.tp_config(cfg, self.mesh))
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

    # -- model-state placement (the 'model' axis) ---------------------------

    def prepare_esm(self, esm_params: dict) -> dict:
        """The frozen backbone (frozen and LoRA modes) cut to this rank's
        slices; the finetune engine's empty slot, or a mesh without a model
        axis, as it is."""
        return sharding.shard_params(self.mesh, esm_params) if esm_params else esm_params

    def prepare_params(self, params: dict) -> dict:
        """A trainable tree (nested, or flat by path as a snapshot holds it)
        with its split leaves, the finetune engine's f32 masters, cut to
        this rank's slices; the heads and LoRA adapters are replicated."""
        return sharding.shard_params(self.mesh, params)

    def export_view(self, params: dict) -> dict:
        """The one-device layout of a trainable tree (the finetune masters
        gathered over the model group; collective)."""
        return sharding.gather_params(self.mesh, params) if self.mesh.model > 1 else params

    def export_esm(self, esm_params: dict) -> dict:
        """The frozen backbone in the one-device layout (collective)."""
        return sharding.gather_params(self.mesh, esm_params) if esm_params else esm_params

    def export_opt_state(self, state: dict) -> dict:
        """An optimizer ``state_dict()`` in the one-device layout
        (collective)."""
        return sharding.gather_opt_state(self.mesh, state)

    def shard_opt_state(self, state: dict) -> dict:
        return sharding.shard_opt_state(self.mesh, state)
