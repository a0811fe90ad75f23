"""Where the time of one serving encode goes, on the card.

    python -m protein_clip_tpu_torch.tools.profile_serve

Builds ESM-2 t30_150M in bf16 with seeded random weights and CLIP heads on
the GPU, then for two requests (one 100-residue sequence; 32 sequences of
50-299 residues) measures the host wall time of ``cli.embed.embed_sequences``
(median of 10, after warm-up) and profiles 5 more calls with
``torch.profiler``: device time by kernel, the device's busy share of the
wall time, and kernel launches per call. Prints the card's name and power
limit beside the numbers.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..cli import common, embed
from ..models import clip, esm2
from ..ops import attention
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
    launches0 = attention.fused_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            encode(seqs)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    k1_calls = (attention.fused_attention.launches - launches0) // n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels) / n
    print(f"[{name}] wall p50 {1e3 * statistics.median(walls):.4f} ms (10 calls); "
          f"profiled {n} calls: device busy {busy_us / n / 1e3:.4f} ms per call = "
          f"{100 * busy_us / 1e6 / window:.2f}% of the wall time; "
          f"{n_launch:.0f} kernel launches per call ({k1_calls} of them K1)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        us = e.self_device_time_total
        print(f"[{name}]   {100 * us / busy_us:6.2f}%  {us / n / 1e3:9.4f} ms/call  "
              f"{e.count // n:5d}x  {e.key[:90]}")


def main() -> int:
    device = resolve_device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {gpu}; torch {torch.__version__}")
    cfg = common.esm_config("t30_150M", "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    esm_params = esm2.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                  dtype=torch.bfloat16, device=device)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
