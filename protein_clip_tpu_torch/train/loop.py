"""Epoch-level training loop with the reference's run-artifact contract:
the port of ``protein_clip_tpu/train/loop.py``.

Per epoch: train (global-batch or per sub-batch) -> validate -> append an
``Epoch,Train Loss,Validation Loss`` row to ``losses_per_epoch.txt`` and a
JSON line to ``metrics.jsonl`` -> on a better validation loss, export the
heads to ``best_model.npz`` (the flat-npz format both packages read) ->
every ``save_state_every`` epochs a train-state snapshot in
``state/epoch_<n>.pt`` (only the newest kept) -> ``epoch_hook``. After the
last epoch, the test loss of the best heads.

Dropout draws from a ``torch.Generator`` on the device seeded from (seed,
epoch), in place of the TPU package's ``fold_in(rng, epoch)``, and the
loaders are reseeded per epoch, so an epoch's stream does not depend on the
ones before it: ``resume=True`` restores the newest snapshot (params,
optimizer state, best params, best validation loss, both loss lists) and
replays the epochs after it as an unbroken run would; the snapshot also
carries the packer's sticky width-tier caches (``packed_engine.tier_state``),
so a resumed ``--pack-tiers`` run packs its batches as the unbroken run
does. The snapshots are the port's own format
(``checkpoint.save_train_state``), not the TPU package's Orbax ones.

On a mesh (``parallel/engine.MeshEngine``: its ``make_prepare`` gives each
rank its part of every batch) every rank runs the loop, and only rank 0
writes: the CSV, ``metrics.jsonl``, ``best_model.npz``, the snapshots and
``epoch_hook``'s figures, as the TPU package's process 0 does; on resume
every rank restores the same snapshot. Under tensor parallelism the params
and optimizer state a rank holds are its slices: ``best_model.npz``, the
snapshots, ``epoch_hook``'s params and the ``FitResult`` take the
one-device layout (the engine's ``export_view`` and ``export_opt_state``,
collective, so every rank calls them and ``epoch_hook``), and a restored
snapshot is cut to the rank's slices again (``prepare_params``,
``shard_opt_state``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Callable

import torch

from . import checkpoint as ckpt
from . import clip_engine, optimizer as opt_mod, packed_engine
from ..data.tokenizer import EsmTokenizer
from ..parallel import distributed


@dataclasses.dataclass
class FitResult:
    train_losses: list[float]
    val_losses: list[float]
    best_val_loss: float
    best_params: Any
    params: Any
    test_loss: float | None = None


def _snapshot(params):
    if isinstance(params, dict):
        return {k: _snapshot(v) for k, v in params.items()}
    return params.detach().clone()


def _snapshots(state_dir: Path) -> list[Path]:
    """The state snapshots in ``state_dir``, oldest epoch first (a ``.tmp``
    file that a cut write left is none)."""
    return sorted(state_dir.glob("epoch_*.pt"), key=lambda p: int(p.stem.split("_")[1]))


def _save_state(state_dir: Path, epoch: int, state: dict) -> None:
    """Snapshot at ``state_dir/epoch_<n>.pt``; the older ones are removed
    only once it is in place."""
    state_dir.mkdir(parents=True, exist_ok=True)
    path = state_dir / f"epoch_{epoch}.pt"
    ckpt.save_train_state(path, state)
    for old in _snapshots(state_dir):
        if old != path:
            old.unlink()


def _restore_latest_state(state_dir: Path, device) -> tuple[dict, int] | None:
    """The newest snapshot and its epoch, or None if there is none."""
    snaps = _snapshots(state_dir) if state_dir.exists() else []
    if not snaps:
        return None
    return ckpt.load_train_state(snaps[-1], device), int(snaps[-1].stem.split("_")[1])


def fit(run_dir: str | Path, cfg: clip_engine.EngineConfig, params: Any, esm_params: Any,
        train_loader, val_loader, tokenizer: EsmTokenizer, num_epochs: int, *, seed: int,
        device, use_gradcache: bool = True, test_loader=None,
        epoch_hook: Callable[[int, Any], None] | None = None,
        log: Callable[[str], None] = print, resume: bool = False, engine=None,
        save_state_every: int = 1) -> FitResult:
    """Train ``params`` (updated in place) for ``num_epochs`` and write the
    run's artifacts into ``run_dir``. ``best_params`` is a copy taken at the
    best validation loss. ``engine`` is a module with ``make_train_step`` and
    ``make_eval_step`` of the ``clip_engine`` signatures (the default), and
    optionally ``make_optimizer`` (``finetune``, ``lora``: two learning-rate
    groups), which replaces the optimizer of the config's trainer knobs.

    ``resume``: continue from the newest snapshot in ``run_dir/state`` (a
    fresh start when there is none), appending to the CSV and
    ``metrics.jsonl``; a snapshot of another tree layout (another mode)
    raises ValueError. ``epoch_hook(epoch, best_params)`` runs after each
    epoch's snapshot (the runners' ``--epoch-figures``), on every rank. An
    engine with ``make_prepare(cfg, tokenizer)`` tokenizes every batch with
    it (the mesh's part of a batch per rank); then only rank 0 writes and
    logs. A mesh engine's params and ``esm_params`` come in already placed
    (``prepare_params``, ``prepare_esm``)."""
    device = torch.device(device)
    run_dir = Path(run_dir)
    primary = distributed.is_primary()
    if primary:
        run_dir.mkdir(parents=True, exist_ok=True)
    else:
        log = lambda _msg: None  # noqa: E731
    engine = engine or clip_engine
    optimizer = (engine.make_optimizer(cfg) if hasattr(engine, "make_optimizer")
                 else opt_mod.from_config(cfg))
    opt_state = optimizer.init(params)
    train_step = engine.make_train_step(cfg)
    eval_step = engine.make_eval_step(cfg)
    prepare = (engine.make_prepare(cfg, tokenizer) if hasattr(engine, "make_prepare")
               else None)
    same = lambda tree: tree  # noqa: E731
    export = getattr(engine, "export_view", same)
    export_opt = getattr(engine, "export_opt_state", same)
    # the snapshot's gathers are collective: every rank of a model axis joins
    sharded = getattr(getattr(engine, "mesh", None), "model", 1) > 1

    losses_path = run_dir / "losses_per_epoch.txt"
    metrics_path = run_dir / "metrics.jsonl"
    model_path = run_dir / "best_model.npz"
    state_dir = run_dir / "state"
    log(f"Best model will be saved to {model_path}")
    log(f"Losses will be saved to {losses_path}")

    train_losses: list[float] = []
    val_losses: list[float] = []
    best_val = float("inf")
    best_params = _snapshot(params)
    start_epoch = 0
    if resume:
        restored = _restore_latest_state(state_dir, device)
        if restored is not None:
            state, start_epoch = restored
            shard = getattr(engine, "prepare_params", same)
            ckpt.load_into(params, shard(state["params"]))
            opt_state.load_state_dict(getattr(engine, "shard_opt_state", same)(
                state["opt_state"]))
            best_params = ckpt.tree_like(params, shard(state["best_params"]))
            best_val = state["best_val"]
            train_losses, val_losses = list(state["train_losses"]), list(state["val_losses"])
            if "tiers" in state:
                packed_engine.restore_tier_state(state["tiers"])
            log(f"Resumed from epoch {start_epoch}")
    mode = "a" if start_epoch > 0 else "w"
    with open(losses_path if primary else os.devnull, mode) as f:
        if mode == "w":
            f.write("Epoch,Train Loss,Validation Loss\n")
        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)
            for loader in (train_loader, val_loader):
                if hasattr(loader, "reseed_epoch"):
                    loader.reseed_epoch(epoch)
            if use_gradcache:
                params, opt_state, train_loss = clip_engine.train_gc(
                    params, opt_state, esm_params, train_loader, tokenizer, train_step, cfg,
                    gen, device, prepare)
            else:
                params, opt_state, train_loss = clip_engine.train_plain(
                    params, opt_state, esm_params, train_loader, tokenizer, train_step, gen,
                    device, cfg, prepare)
            val_loss = clip_engine.evaluate(params, esm_params, val_loader, tokenizer,
                                            eval_step, device, cfg, prepare)
            train_losses.append(train_loss)
            val_losses.append(val_loss)
            f.write(f"{epoch + 1},{train_loss:.4f},{val_loss:.4f}\n")
            f.flush()

            if val_loss < best_val:
                best_val = val_loss
                best_params = _snapshot(params)
                best_full = export(best_params)
                if primary:
                    ckpt.export_npz(model_path, best_full)

            dt = time.perf_counter() - t0
            if primary:
                with open(metrics_path, "a") as mf:
                    mf.write(json.dumps({"epoch": epoch + 1, "train_loss": train_loss,
                                         "val_loss": val_loss, "seconds": dt}) + "\n")
            log(f"Epoch {epoch + 1}/{num_epochs} - Train Loss: {train_loss:.4f}, "
                f"Val Loss: {val_loss:.4f} ({dt:.1f}s)")
            if (epoch + 1) % save_state_every == 0 and (primary or sharded):
                state = {"params": export(params), "opt_state": export_opt(opt_state.state_dict()),
                         "best_params": export(best_params), "best_val": best_val,
                         "train_losses": train_losses, "val_losses": val_losses,
                         "tiers": packed_engine.tier_state()}
                if primary:
                    _save_state(state_dir, epoch + 1, state)
                del state
            if epoch_hook is not None:
                epoch_hook(epoch, export(best_params))

    test_loss = None
    if test_loader is not None:
        test_loss = clip_engine.evaluate(best_params, esm_params, test_loader, tokenizer,
                                         eval_step, device, cfg, prepare)
        log(f"Test Loss: {test_loss:.4f}")
    return FitResult(train_losses, val_losses, best_val, export(best_params), export(params),
                     test_loss)
