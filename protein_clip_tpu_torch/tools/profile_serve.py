"""Where the time of one serving request goes, on the card.

    python -m protein_clip_tpu_torch.tools.profile_serve [--esm-dtype int8]
    PCT_FFN_PALLAS=1 python -m protein_clip_tpu_torch.tools.profile_serve

Builds ESM-2 t30_150M in bf16 (with ``--esm-dtype int8``, its w8a8
quantisation, whose linear layers run P1) with seeded random weights and
CLIP heads on the GPU, then for two requests (one 100-residue sequence;
32 sequences of 50-299 residues) measures the host wall time of
``cli.embed.embed_sequences`` (median of 10, after warm-up) and profiles 5
more calls with ``torch.profiler``: device time by kernel, the device's
busy share of the wall time, and kernel launches per call. Then the same
for FILIP's /topk without HTTP (``embed_sequences_tokens`` for one
100-residue query, then ``filip_score_matrix_ragged`` over a ragged index
of 256 sequences of 30-499 residues). Under ``PCT_FFN_PALLAS=1`` every
FFN's wi + gelu runs K6. Each request's line names the launches of K1, K4,
P1 and K6 per call and the share of the device time of each. Prints the
card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..cli import common, embed
from ..eval import retrieval
from ..models import clip, esm2, filip
from ..ops import attention, dense_mm, ffn
from ..ops import filip as maxsim
from ..utils.device import resolve_device

AAS = "LAGVSERTIDPKQNFYMHWC"


def profile_request(name: str, seqs: list[str], encode, top: int = 12) -> None:
    for _ in range(3):
        encode(seqs)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(seqs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n = 5
    counters = {"K1": attention.fused_attention, "K4": maxsim.filip_similarity_fused,
                "P1": dense_mm.mm, "K6": ffn.dense_gelu}
    before = {k: fn.launches for k, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            encode(seqs)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    calls = {k: (fn.launches - before[k]) // n for k, fn in counters.items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels) / n
    # P1 and K6 are one kernel template (csrc/mma_gemm.cuh's gemm_kernel),
    # told apart by their epilogue types
    shares = {k: sum(e.self_device_time_total for e in kernels if sym in e.key)
              for k, sym in (("K1", "attention_fwd_kernel"), ("K4", "filip_maxsim_kernel"),
                             ("P1", "DenseMmOut"), ("K6", "FfnGeluOut"))}
    print(f"[{name}] wall p50 {1e3 * statistics.median(walls):.4f} ms (10 calls); "
          f"profiled {n} calls: device busy {busy_us / n / 1e3:.4f} ms per call = "
          f"{100 * busy_us / 1e6 / window:.2f}% of the wall time; "
          f"{n_launch:.0f} kernel launches per call ("
          + ", ".join(f"{calls[k]} {k}" for k in counters) + "); "
          + ", ".join(f"{k} {100 * us / busy_us:.2f}% of the device time "
                      f"({us / n / 1e3:.4f} ms/call)" for k, us in shares.items()))
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        us = e.self_device_time_total
        print(f"[{name}]   {100 * us / busy_us:6.2f}%  {us / n / 1e3:9.4f} ms/call  "
              f"{e.count // n:5d}x  {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--esm-dtype", default="bfloat16", choices=["bfloat16", "int8"])
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {gpu}; torch {torch.__version__}; --esm-dtype {args.esm_dtype}, "
          f"PCT_FFN_PALLAS={os.environ.get('PCT_FFN_PALLAS', '')!r}")
    cfg = common.esm_config("t30_150M", args.esm_dtype)
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    esm_params = esm2.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                  dtype=torch.bfloat16, device=device)
    if args.esm_dtype == "int8":
        esm_params = esm2.quantize_params(esm_params)
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(0), device=device)
    tok = common.make_tokenizer()
    rng = np.random.default_rng(0)

    def seqs(lengths):
        return ["".join(rng.choice(list(AAS), int(n))) for n in lengths]

    def encode(batch):
        return embed.embed_sequences(heads, esm_params, batch, "rec", mcfg, tok, device,
                                     batch_size=32, pad_batch=True)

    profile_request("1 seq, 100 aa", seqs([100]), encode)
    profile_request("32 seqs, 50-299 aa", seqs(rng.integers(50, 300, 32)), encode)

    fcfg = embed.filip_config(mcfg)
    fheads = filip.init_params(fcfg, torch.Generator().manual_seed(1), device=device)
    flat, lengths = embed.embed_sequences_tokens_ragged(
        fheads, esm_params, sorted(seqs(rng.integers(30, 500, 256)), key=len), "rec", fcfg,
        tok, device, batch_size=32)

    def topk(batch):
        q_t, q_m = embed.embed_sequences_tokens(fheads, esm_params, batch, "pep", fcfg, tok,
                                                device, batch_size=32, pad_batch=True)
        return retrieval.filip_score_matrix_ragged(q_t, q_m, flat, lengths,
                                                   fheads["temperature"], device=device)

    profile_request("FILIP /topk, 1 query of 100 aa over 256 seqs", seqs([100]), topk)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
