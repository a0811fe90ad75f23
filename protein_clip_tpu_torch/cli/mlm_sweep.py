"""MLM masking-rate sweep (the port of ``protein_clip_tpu.cli.mlm_sweep``).

    python -m protein_clip_tpu_torch.cli.mlm_sweep --synthetic-fixture --data-dir d \\
        [--prefix peptide] [--n-sequences 200] [--probs 0.05 0.1 0.2] [--mask-char .]

Masks the first --n-sequences of <prefix>.fasta at each probability with
--mask-char ('.', ESM vocab id 29) and prints the mean fraction of changed
token ids per probability; the box plot's data goes into the run
directory (``eval/mlm_sweep.plot_sweep``: ``figures/figure N.npy``, and the
PNG where matplotlib is installed). Pure Python and NumPy: no device.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import common
from ..data.fasta import sequences_only
from ..eval.mlm_sweep import plot_sweep, sweep
from ..utils import prng, rundir


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_data_args(p)
    p.add_argument("--prefix", default="peptide", help="which FASTA to sample sequences from")
    p.add_argument("--n-sequences", type=int, default=200)
    p.add_argument("--probs", type=float, nargs="+", default=[0.05, 0.1, 0.2, 0.3, 0.4, 0.5])
    p.add_argument("--mask-char", default=".")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    prng.set_seed(args.seed)
    run_dir = rundir.make_run_dir(args.runs_dir)
    data_dir = common.ensure_data(args, args.prefix, args.prefix)
    seqs = sequences_only(data_dir / f"{args.prefix}.fasta")[:args.n_sequences]
    result = sweep(seqs, probs=tuple(args.probs), mask_char=args.mask_char, seed=args.seed)
    for p in sorted(result):
        print(f"p={p}: mean changed fraction {np.mean(result[p]):.3f}")
    print(f"sweep plot saved to {plot_sweep(run_dir, result)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
