"""Peptide-receptor CLIP training (the port of ``protein_clip_tpu.cli.main``).

    python -m protein_clip_tpu_torch.cli.main --synthetic-fixture --data-dir d \\
        --fixture-families 3000 --epochs 1 [--device cpu]

The reference recipe and defaults: frozen ESM-2 t30 backbone, dual 128-d
heads (h1 = h2 = 2, dropout 0.1), Adam 1e-3, batch 16 x accumulation 16 =
256 global negatives in 4 length groups, 25 epochs, best-validation
checkpointing into runs/<timestamp>/. Runs on cuda unless --device cpu.
"""

from __future__ import annotations

import argparse

from . import common
from ._clip_runner import run_clip_training


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_train_args(p)
    common.add_mesh_args(p)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--accumulated-batches", type=int, default=16)
    p.add_argument("--no-gradcache", action="store_true",
                   help="plain per-batch training (one step per sub-batch)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_clip_training(args, prefix_a="peptide", prefix_b="receptor")


if __name__ == "__main__":
    raise SystemExit(main())
