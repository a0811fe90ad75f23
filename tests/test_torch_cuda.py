"""The port's CUDA kernels on the card: K1 and K4 against their plain
versions at odd shapes, the wrappers' refusals, their launch counts, the
ESM-2 forward through K1 and the FILIP scorer through K4.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. This file
imports torch and the port only, so on a machine without JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from protein_clip_tpu_torch.eval import retrieval
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.ops import attention, filip

pytestmark = pytest.mark.cuda

# the kernel normalises after P.V, the plain version before the bf16 cast
# of P: bf16 rounding apart. |err| <= ATOL_RMS * rms(ref) + RTOL * |ref|, as
# in chip_smoke.py, which states the margin.
ATOL_RMS, RTOL = 2 ** -5, 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card: "
                    "python -m pytest tests/test_torch_cuda.py --noconftest)")
    return torch.device("cuda")


def _inputs(B, T, NH, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = ((s * torch.randn(B, T, NH, 32, device=dev, generator=g)).bfloat16()
               for s in (32 ** -0.5, 1.0, 1.0))
    return q, k, v


def _segments(B, T, kind, dev):
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        if kind == "padded":
            seg[b, : max(1, T - b * T // (B + 1))] = 1
        else:  # packed: three segments and gaps
            seg[b, : T // 3] = 1
            seg[b, T // 3 + 1: 2 * T // 3] = 2
            seg[b, 2 * T // 3 + 1:] = 3
    return seg.to(dev)


@pytest.mark.parametrize("kind", ["padded", "packed"])
@pytest.mark.parametrize("B,T,NH", [(1, 1, 1), (2, 33, 3), (3, 100, 20), (1, 64, 2),
                                    (2, 130, 5), (1, 1000, 4)])
def test_kernel_matches_plain(dev, B, T, NH, kind):
    q, k, v = _inputs(B, T, NH, dev)
    seg = _segments(B, T, kind, dev)
    got = attention.fused_attention(q, k, v, seg)
    torch.cuda.synchronize()
    ref = attention.attention_reference(q, k, v, seg).float()
    assert torch.isfinite(got).all()
    err = (got.float() - ref).abs()
    atol = ATOL_RMS * float(ref.square().mean().sqrt())
    assert (err <= atol + RTOL * ref.abs()).all(), float(err.max())


def test_launch_count(dev):
    q, k, v = _inputs(1, 64, 2, dev)
    seg = _segments(1, 64, "padded", dev)
    before = attention.fused_attention.launches
    for _ in range(3):
        attention.fused_attention(q, k, v, seg)
    assert attention.fused_attention.launches == before + 3


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _inputs(1, 64, 2, dev)
    seg = _segments(1, 64, "padded", dev)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.fused_attention(q.float(), k.float(), v.float(), seg)
    with pytest.raises(TypeError, match="int32"):
        attention.fused_attention(q, k, v, seg.long())
    with pytest.raises(ValueError, match="32"):
        attention.fused_attention(q[..., :16], k[..., :16], v[..., :16], seg)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  seg[:, :2])
    with pytest.raises(ValueError, match="segments"):
        attention.fused_attention(q, k, v, seg[:, :10])
    with pytest.raises(NotImplementedError, match="backward"):
        attention.fused_attention(q.requires_grad_(), k, v, seg)


@pytest.mark.parametrize("over", [dict(hidden_size=256, num_heads=4),       # head_dim 64
                                  dict(compute_dtype=torch.float32)])
def test_esm_forward_refuses_configs_the_kernel_does_not_take(dev, over):
    """Fused attention on CUDA never falls back to the plain form."""
    cfg = esm2.ESM2Config(**{**dict(hidden_size=128, num_layers=1, num_heads=4,
                                    intermediate_size=256, compute_dtype=torch.bfloat16),
                             **over})
    params = esm2.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dtype=cfg.compute_dtype, device=dev)
    ids = torch.randint(4, 24, (1, 16), device=dev)
    mask = torch.ones(1, 16, dtype=torch.int32, device=dev)
    before = attention.fused_attention.launches
    with torch.inference_mode(), pytest.raises(NotImplementedError, match="head_dim"):
        esm2.forward(params, ids, mask, cfg)
    assert attention.fused_attention.launches == before


def test_esm_forward_runs_the_kernel_in_every_layer(dev):
    cfg = esm2.ESM2Config(hidden_size=128, num_layers=3, num_heads=4, intermediate_size=256,
                          compute_dtype=torch.bfloat16)
    params = esm2.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dtype=torch.bfloat16, device=dev)
    ids = torch.randint(4, 24, (2, 70), device=dev)
    mask = torch.ones(2, 70, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    ids[1, 40:] = 1
    before = attention.fused_attention.launches
    with torch.inference_mode():
        fused = esm2.forward(params, ids, mask, cfg)
        eager = esm2.forward(params, ids, mask,
                             dataclasses.replace(cfg, attention_impl="eager"))
    assert attention.fused_attention.launches == before + cfg.num_layers
    valid = mask.bool()
    cos = torch.nn.functional.cosine_similarity(fused[valid].float(), eager[valid].float(),
                                                dim=-1)
    assert float(cos.min()) >= 0.999


# K4: f32 scores on the CUDA cores; the kernel and the plain version sum the
# same products in another order. Outputs are means of maxima of unit-vector
# dot products, |x| <= 1.
K4_ATOL = 2e-5


def _tokens(Ba, Bb, TA, TB, dev, D=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ha = torch.nn.functional.normalize(torch.randn(Ba, TA, D, device=dev, generator=g), dim=-1)
    hb = torch.nn.functional.normalize(torch.randn(Bb, TB, D, device=dev, generator=g), dim=-1)
    ma = (torch.rand(Ba, TA, device=dev, generator=g) < 0.9).to(torch.int32)
    mb = (torch.rand(Bb, TB, device=dev, generator=g) < 0.9).to(torch.int32)
    ma[:, TA - TA // 3:] = 0          # padded suffixes
    mb[:, TB - TB // 4:] = 0
    ma[0] = 0                         # an a-row and a b-row with no valid token
    mb[-1] = 0
    return ha, hb, ma, mb


@pytest.mark.parametrize("Ba,Bb,TA,TB,D", [(1, 1, 1, 1, 128), (2, 3, 33, 70, 128),
                                           (3, 5, 64, 64, 128), (2, 7, 130, 257, 128),
                                           (4, 9, 32, 2048, 128), (2, 3, 50, 90, 8),
                                           (2, 2, 17, 40, 256)])
def test_maxsim_kernel_matches_plain(dev, Ba, Bb, TA, TB, D):
    ha, hb, ma, mb = _tokens(Ba, Bb, TA, TB, dev, D)
    got = filip.filip_similarity_fused(ha, hb, ma, mb, 1.0)
    torch.cuda.synchronize()
    want = filip.maxsim_reference(ha, hb, ma, mb)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= K4_ATOL
    if Ba > 1 and Bb > 1:   # the clamp: empty rows score 0
        assert (got[0][0] == 0).all() and (got[1][:, -1] == 0).all()


def test_maxsim_launch_count_and_temperature(dev):
    ha, hb, ma, mb = _tokens(2, 3, 40, 70, dev)
    before = filip.filip_similarity_fused.launches
    raw = filip.filip_similarity_fused(ha, hb, ma, mb, 1.0)
    scaled = filip.filip_similarity_fused(ha, hb, ma, mb, torch.tensor(1e-6, device=dev))
    assert filip.filip_similarity_fused.launches == before + 2
    for r, s in zip(raw, scaled):
        torch.testing.assert_close(s, r / 1e-4)     # t floored at 1e-4


def test_maxsim_wrapper_refuses_what_the_kernel_does_not_take(dev):
    ha, hb, ma, mb = _tokens(2, 3, 40, 70, dev)
    with pytest.raises(TypeError, match="float32"):
        filip.filip_similarity_fused(ha.bfloat16(), hb, ma, mb, 1.0)
    with pytest.raises(TypeError, match="int32"):
        filip.filip_similarity_fused(ha, hb, ma.long(), mb, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        filip.filip_similarity_fused(ha.transpose(0, 1).contiguous().transpose(0, 1), hb,
                                     ma, mb, 1.0)
    with pytest.raises(ValueError, match="masks"):
        filip.filip_similarity_fused(ha, hb, ma[:, :10], mb, 1.0)
    with pytest.raises(ValueError, match="multiple of 4"):
        filip.filip_similarity_fused(ha[..., :6].contiguous(), hb[..., :6].contiguous(),
                                     ma, mb, 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        long = torch.zeros(1, 60000, 128, device=dev)
        filip.filip_similarity_fused(ha, long, ma, torch.zeros(1, 60000, dtype=torch.int32,
                                                               device=dev), 1.0)
    with pytest.raises(NotImplementedError, match="backward"):
        filip.filip_similarity_fused(ha.requires_grad_(), hb, ma, mb, 1.0)


def test_ragged_scorer_launches_one_kernel_per_block(dev):
    """filip_score_matrix_ragged on the card: one launch per (row block,
    column block), and the plain version's scores."""
    ha, hb, ma, mb = _tokens(5, 11, 40, 100, dev)
    lengths = mb.sum(1).cpu().numpy()
    mb_sorted = torch.zeros_like(mb)   # the ragged form keeps each row's valid tokens first
    flat = []
    for j in range(hb.shape[0]):
        keep = mb[j].bool()
        flat.append(hb[j][keep].cpu().numpy())
        mb_sorted[j, :int(lengths[j])] = 1
        hb[j, :int(lengths[j])] = hb[j][keep].clone()
        hb[j, int(lengths[j]):] = 0
    before = filip.filip_similarity_fused.launches
    got = retrieval.filip_score_matrix_ragged(ha.cpu().numpy(), ma.cpu().numpy(),
                                              np.concatenate(flat), lengths, 0.7, row_block=2,
                                              col_block=4, device=dev)
    assert filip.filip_similarity_fused.launches == before + 3 * 3
    sa, sb = filip.maxsim_reference(ha, hb, ma, mb_sorted)
    want = ((sa + sb) / 2 / 0.7).cpu().numpy()
    assert np.abs(got - want).max() <= K4_ATOL
