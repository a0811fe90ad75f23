"""Convert a HF ESM-2 checkpoint directory to the flat npz that
``--esm-weights`` reads (the port of the TPU package's
``tools/convert_esm_weights.py``):

    python -m protein_clip_tpu_torch.tools.convert_esm_weights \
        --hf esm2_t30_150M_UR50D/ --out esm2_t30_150M.npz [--config t30_150M] [--lm-head]

``--hf`` is a local directory holding ``config.json`` and
``model.safetensors`` or ``pytorch_model.bin`` (sharded or not), as
``save_pretrained`` writes it; a hub id would need the network, which this
tool does not use. The backbone's tensors are read without ``transformers``
(``train/checkpoint.read_hf_checkpoint``), converted to the stacked f32 tree
(``models/esm2.convert_hf_state_dict``) and written with ``export_npz``, the
format both packages' ``--esm-weights x.npz`` load. ``--lm-head`` also
writes the MLM head to ``<out stem>_lm_head.npz``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..cli.common import ESM_FAMILIES
from ..models import esm2
from ..train import checkpoint


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hf", required=True, help="local HF checkpoint directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default="t30_150M", choices=ESM_FAMILIES)
    ap.add_argument("--lm-head", action="store_true",
                    help="also export the MLM head (an EsmForMaskedLM checkpoint)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    src = Path(args.hf)
    if not src.is_dir():
        raise FileNotFoundError(
            f"--hf {args.hf} is not a local directory: a HF hub id needs the network, which "
            "this tool does not use; pass a directory that save_pretrained wrote")
    cfg = getattr(esm2.ESM2Config, args.config)()
    sd = checkpoint.read_hf_checkpoint(src, lm_head=args.lm_head)
    checkpoint.export_npz(args.out, esm2.convert_hf_state_dict(sd, cfg))
    print(f"wrote backbone params -> {args.out}")
    if args.lm_head:
        head_path = str(Path(args.out).with_suffix("")) + "_lm_head.npz"
        checkpoint.export_npz(head_path, esm2.convert_hf_lm_head(sd))
        print(f"wrote LM head -> {head_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
