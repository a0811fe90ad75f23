"""Epoch-level training loop with the reference's run-artifact contract:
the port of ``protein_clip_tpu/train/loop.py``.

Per epoch: train (global-batch or per sub-batch) -> validate -> append an
``Epoch,Train Loss,Validation Loss`` row to ``losses_per_epoch.txt`` and a
JSON line to ``metrics.jsonl`` -> on a better validation loss, export the
heads to ``best_model.npz`` (the flat-npz format both packages read). After
the last epoch, the test loss of the best heads.

Dropout draws from a ``torch.Generator`` on the device seeded from (seed,
epoch), in place of the TPU package's ``fold_in(rng, epoch)``, and the
loaders are reseeded per epoch, so an epoch's stream does not depend on the
ones before it. The TPU package's Orbax state snapshots and ``resume`` are
not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable

import torch

from . import checkpoint as ckpt
from . import clip_engine, optimizer as opt_mod
from ..data.tokenizer import EsmTokenizer


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


def fit(run_dir: str | Path, cfg: clip_engine.EngineConfig, params: Any, esm_params: Any,
        train_loader, val_loader, tokenizer: EsmTokenizer, num_epochs: int, *, seed: int,
        device, use_gradcache: bool = True, test_loader=None,
        log: Callable[[str], None] = print, resume: bool = False, engine=None) -> FitResult:
    """Train ``params`` (updated in place) for ``num_epochs`` and write the
    run's artifacts into ``run_dir``. ``best_params`` is a copy taken at the
    best validation loss. ``engine`` is a module with ``make_train_step`` and
    ``make_eval_step`` of the ``clip_engine`` signatures (the default), and
    optionally ``make_optimizer`` (``finetune``, ``lora``: two learning-rate
    groups), which replaces the optimizer of the config's trainer knobs."""
    if resume:
        raise NotImplementedError("resuming a run is not ported yet (ROADMAP queue 1: "
                                  "train-state snapshots and resume)")
    device = torch.device(device)
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    engine = engine or clip_engine
    optimizer = (engine.make_optimizer(cfg) if hasattr(engine, "make_optimizer")
                 else opt_mod.from_config(cfg))
    opt_state = optimizer.init(params)
    train_step = engine.make_train_step(cfg)
    eval_step = engine.make_eval_step(cfg)

    losses_path = run_dir / "losses_per_epoch.txt"
    metrics_path = run_dir / "metrics.jsonl"
    model_path = run_dir / "best_model.npz"
    log(f"Best model will be saved to {model_path}")
    log(f"Losses will be saved to {losses_path}")

    train_losses: list[float] = []
    val_losses: list[float] = []
    best_val = float("inf")
    best_params = _snapshot(params)
    with open(losses_path, "w") as f:
        f.write("Epoch,Train Loss,Validation Loss\n")
        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)
            for loader in (train_loader, val_loader):
                if hasattr(loader, "reseed_epoch"):
                    loader.reseed_epoch(epoch)
            if use_gradcache:
                params, opt_state, train_loss = clip_engine.train_gc(
                    params, opt_state, esm_params, train_loader, tokenizer, train_step, cfg,
                    gen, device)
            else:
                params, opt_state, train_loss = clip_engine.train_plain(
                    params, opt_state, esm_params, train_loader, tokenizer, train_step, gen,
                    device, cfg)
            val_loss = clip_engine.evaluate(params, esm_params, val_loader, tokenizer,
                                            eval_step, device, cfg)
            train_losses.append(train_loss)
            val_losses.append(val_loss)
            f.write(f"{epoch + 1},{train_loss:.4f},{val_loss:.4f}\n")
            f.flush()

            if val_loss < best_val:
                best_val = val_loss
                best_params = _snapshot(params)
                ckpt.export_npz(model_path, best_params)

            dt = time.perf_counter() - t0
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps({"epoch": epoch + 1, "train_loss": train_loss,
                                     "val_loss": val_loss, "seconds": dt}) + "\n")
            log(f"Epoch {epoch + 1}/{num_epochs} - Train Loss: {train_loss:.4f}, "
                f"Val Loss: {val_loss:.4f} ({dt:.1f}s)")

    test_loss = None
    if test_loader is not None:
        test_loss = clip_engine.evaluate(best_params, esm_params, test_loader, tokenizer,
                                         eval_step, device, cfg)
        log(f"Test Loss: {test_loss:.4f}")
    return FitResult(train_losses, val_losses, best_val, best_params, params, test_loss)
