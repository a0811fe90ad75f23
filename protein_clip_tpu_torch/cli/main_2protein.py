"""Protein-protein CLIP training (the port of
``protein_clip_tpu.cli.main_2protein``).

    python -m protein_clip_tpu_torch.cli.main_2protein --synthetic-fixture \\
        --data-dir d2 --epochs 1 [--device cpu]

Two-chain pairs (protein1/protein2 FASTAs), an ingest filter of length
<= 2000, 20 epochs; otherwise the ``main`` recipe. The cluster-size
histogram of the TPU package's run is a figure and is not ported.
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
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--accumulated-batches", type=int, default=16)
    p.add_argument("--no-gradcache", action="store_true")
    p.add_argument("--max-sequence-length", type=int, default=2000)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_clip_training(args, prefix_a="protein1", prefix_b="protein2",
                             max_sequence_length=args.max_sequence_length)


if __name__ == "__main__":
    raise SystemExit(main())
