"""The port's CUDA kernels on the card: K1 and its backward K5, K4, the
InfoNCE kernels K2 and K3 (forward and backward), the dense product P1 (s8
and bf16) and the fused FFN K6 against their plain versions at odd shapes,
each tolerance against a planted fault, the wrappers' refusals, their
launch counts, the ESM-2 forward through K1, P1 (int8) and K6, the FILIP
scorer through K4, a train step through K2 and K3, and finetune steps
through K1 and K5, and under the K6 gate.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. This file
imports torch and the port only, so on a machine without JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.eval import retrieval
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.ops import attention, dense_mm, ffn, filip, infonce
from protein_clip_tpu_torch.train import clip_engine, optimizer

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
    with pytest.raises(ValueError, match="do shape"):
        attention.fused_attention_bwd(q, k, v, seg, q[:, :10].contiguous())


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


# K5 against its plain version, both bf16 out: the kernel rounds P and dS to
# bf16 at f32 values that differ from the plain version's by the order of
# their sums (an online max and sums over 64-key tiles against one softmax),
# and the outputs are bf16 (2^-8 relative, within RTOL). Same form and
# numbers as K1's; chip_smoke.py prints the least atol that passes.
def _bwd_segments(B, T, kind, dev):
    if kind == "packed":
        return _segments(B, T, "packed", dev)
    seg = _segments(B, T, "padded", dev)
    if kind == "fully_padded":
        seg[-1] = 0    # a row with no valid token: every one of its queries is uniform
    return seg


def _assert_bwd_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        w = w.float()
        err = (g.float() - w).abs()
        atol = ATOL_RMS * float(w.square().mean().sqrt())
        assert (err <= atol + RTOL * w.abs()).all(), (name, float(err.max()))


@pytest.mark.parametrize("kind", ["padded", "fully_padded", "packed"])
@pytest.mark.parametrize("T", [1, 63, 64, 200, 512, 2048])
@pytest.mark.parametrize("B", [1, 16])
def test_attention_bwd_kernel_matches_plain(dev, B, T, kind):
    NH = 4 if T <= 512 else 2
    q, k, v = _inputs(B, T, NH, dev)
    do = _inputs(B, T, NH, dev, seed=1)[2]
    seg = _bwd_segments(B, T, kind, dev)
    got = attention.fused_attention_bwd(q, k, v, seg, do)
    torch.cuda.synchronize()
    _assert_bwd_close(got, attention.attention_reference_bwd(q, k, v, seg, do))


def test_attention_bwd_is_deterministic_and_counts_launches(dev):
    q, k, v = _inputs(16, 200, 20, dev)
    do = _inputs(16, 200, 20, dev, seed=1)[2]
    seg = _bwd_segments(16, 200, "packed", dev)
    before = attention.fused_attention_bwd.launches
    a = attention.fused_attention_bwd(q, k, v, seg, do)
    b = attention.fused_attention_bwd(q, k, v, seg, do)
    assert attention.fused_attention_bwd.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fused_attention_function_runs_k1_then_k5(dev):
    """Through autograd: K1 once forward, K5 once backward, and the plain
    backward's gradients; under no_grad K1 alone."""
    q, k, v = (t.requires_grad_(True) for t in _inputs(3, 130, 20, dev))
    do = _inputs(3, 130, 20, dev, seed=1)[2]
    seg = _bwd_segments(3, 130, "padded", dev)
    k1, k5 = attention.fused_attention.launches, attention.fused_attention_bwd.launches
    out = attention.fused_attention(q, k, v, seg)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (attention.fused_attention.launches, attention.fused_attention_bwd.launches) == (
        k1 + 1, k5 + 1)
    _assert_bwd_close(grads, attention.attention_reference_bwd(
        q.detach(), k.detach(), v.detach(), seg, do))
    with torch.no_grad():
        attention.fused_attention(q, k, v, seg)
    assert attention.fused_attention_bwd.launches == k5 + 1


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


# K2 / K3: f32 FFMA against the plain version's f32 matmul and logsumexp,
# the same sums in another order over up to B terms: |loss - ref| <=
# 1e-5 max(1, |ref|), |grad - ref| <= 1e-5 max|ref|.
INFONCE_RTOL = 1e-5


def _unit_rows(B, D, t, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x, y = (torch.nn.functional.normalize(torch.randn(B, D, device=dev, generator=g), dim=-1)
            * float(np.exp(t / 2)) for _ in range(2))
    return x.contiguous(), y.contiguous()


def _value_and_grads(fn, x, y):
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    loss = fn(xr, yr)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), xr.grad, yr.grad


@pytest.mark.parametrize("t", [1.0, 4.0])
@pytest.mark.parametrize("tiled,B,D", [(False, 1, 128), (False, 5, 128), (False, 63, 64),
                                       (False, 65, 128), (False, 100, 4), (False, 256, 132),
                                       (False, 300, 256), (True, 1, 128), (True, 77, 64),
                                       (True, 700, 128), (True, 1031, 36)])
def test_infonce_kernels_match_plain(dev, tiled, B, D, t):
    x, y = _unit_rows(B, D, t, dev)
    fn = infonce.fused_infonce_tiled if tiled else infonce.fused_infonce
    got = _value_and_grads(fn, x, y)
    want = _value_and_grads(infonce.clip_infonce, x, y)
    assert all(torch.isfinite(v).all() for v in got)
    assert abs(float(got[0] - want[0])) <= INFONCE_RTOL * max(1.0, abs(float(want[0])))
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= INFONCE_RTOL * float(w.abs().max())


@pytest.mark.parametrize("tiled", [False, True])
def test_infonce_is_deterministic_and_counts_calls(dev, tiled):
    fn = infonce.fused_infonce_tiled if tiled else infonce.fused_infonce
    x, y = _unit_rows(300, 128, 2.0, dev)
    before = (fn.launches, fn.bwd_launches)
    a = _value_and_grads(fn, x, y)
    b = _value_and_grads(fn, x, y)
    assert (fn.launches, fn.bwd_launches) == (before[0] + 2, before[1] + 2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with torch.inference_mode():
        fn(x, y)
    assert (fn.launches, fn.bwd_launches) == (before[0] + 3, before[1] + 2)


def test_infonce_backward_scales_by_the_cotangent(dev):
    x, y = _unit_rows(40, 64, 1.0, dev)
    _, gx, gy = _value_and_grads(infonce.fused_infonce, x, y)
    _, sx, sy = _value_and_grads(lambda a, b: 2.5 * infonce.fused_infonce(a, b), x, y)
    torch.testing.assert_close(sx, 2.5 * gx)
    torch.testing.assert_close(sy, 2.5 * gy)


def test_infonce_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, y = _unit_rows(16, 64, 1.0, dev)
    for fn in (infonce.fused_infonce, infonce.fused_infonce_tiled):
        with pytest.raises(TypeError, match="float32"):
            fn(x.bfloat16(), y.bfloat16())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.T, y.T)
        with pytest.raises(ValueError, match="multiple of 4"):
            fn(x[:, :6].contiguous(), y[:, :6].contiguous())
        with pytest.raises(ValueError, match="aligned"):
            off = torch.zeros(16 * 64 + 1, device=dev)[1:].view(16, 64)
            fn(off, y)
        with pytest.raises(ValueError, match="on cpu"):
            fn(x, y.cpu())


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _tiny_t30_like(dev):
    """Two layers at t30_150M's head_dim 32 in bf16, which K1 takes."""
    esm_cfg = esm2.ESM2Config(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
                              compute_dtype=torch.bfloat16)
    mcfg = clip.CLIPConfig(input_dim=128, embedding_dim=64, dropout=0.0, esm=esm_cfg)
    esm_params = esm2.init_params(esm_cfg, torch.Generator(device=dev).manual_seed(0),
                                  dtype=torch.bfloat16, device=dev)
    return mcfg, esm_params


def _capturing(state):
    """Make ``state.apply`` keep the gradients it applies, in leaf order."""
    apply = state.apply

    def capture():
        state.grads = [t.grad.detach().clone() for t in state.leaves]
        apply()

    state.apply = capture
    return state


@pytest.mark.parametrize("pool,tiled", [(64, False), (640, True)])
def test_train_step_through_the_kernels_matches_the_plain_loss(dev, pool, tiled):
    """One grouped train step with the default loss (K2 or K3) and one with
    the plain loss, from the same heads and batch: the loss within 1e-5
    relative, each gradient within 1e-5 of its leaf's largest, and each
    updated head parameter within what Adam's first update allows for
    those gradients. That update is lr g / (|g| + eps), which moves by at
    most 2 lr |dg| / (max|g| + eps) when g moves by dg: near g = 0 it turns
    f32 noise into up to lr, so a flat 1e-5 on the parameters would test
    the noise, not the kernels."""
    lr = 1e-3
    mcfg, esm_params = _tiny_t30_like(dev)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=pool // 4, accumulated_batches=4,
                                   num_chunks=4, length_groups=2)
    rng = np.random.default_rng(0)
    aas = list("LAGVSERTIDPKQNFYMHWC")
    peps = ["".join(rng.choice(aas, int(n))) for n in rng.integers(8, 30, pool)]
    recs = ["".join(rng.choice(aas, int(n))) for n in rng.integers(30, 90, pool)]
    batch = clip_engine.tokenize_grouped(EsmTokenizer(), peps, recs, 2)
    batch = tuple({k: v.to(dev) for k, v in b.items()} for b in batch)
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(1), device=dev)
    fn = infonce.fused_infonce_tiled if tiled else infonce.fused_infonce
    out = {}
    for name, loss_fn in (("kernel", None), ("plain", infonce.clip_infonce)):
        params = _clone(heads0)
        state = _capturing(optimizer.adam(lr).init(params))
        before = (fn.launches, fn.bwd_launches)
        params, state, loss = clip_engine.make_train_step(cfg, loss_fn)(
            params, state, esm_params, batch, None)
        torch.cuda.synchronize()
        launched = (fn.launches - before[0], fn.bwd_launches - before[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        out[name] = (float(loss), state.grads, [t.detach() for t in state.leaves])
    (lk, gk, pk), (lp, gp, pp) = out["kernel"], out["plain"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for a, b, ga, gb in zip(pk, pp, gk, gp):
        allowed = 1e-6 + 2 * lr * (ga - gb).abs() / (torch.maximum(ga.abs(), gb.abs()) + 1e-8)
        assert bool(((a - b).abs() <= allowed).all())


# The finetune step through K1/K5 against the same step through K1 and K5's
# plain version, which differ only by the order of K5's f32 sums: per leaf
# max|err| <= FT_K5_TOL max|g_plain|, the loss within FT_LOSS_TOL relative
# (both steps run K1's forward: the loss agrees exactly). On an H100 the
# worst leaf reads 0.0026 and a K5 that drops its last query tile 0.98.
FT_LOSS_TOL, FT_K5_TOL = 1e-6, 1e-2


def _drop_last_query_tile(bwd):
    """K5 whose dk/dv loop drops the last 64-query tile (a planted fault):
    zeroing dO on those queries removes exactly their dk and dv terms."""
    def fault(q, k, v, segments, do):
        cut = do.clone()
        cut[:, (q.shape[1] - 1) // 64 * 64:] = 0
        return (bwd(q, k, v, segments, do)[0], *bwd(q, k, v, segments, cut)[1:])
    return fault


@contextlib.contextmanager
def _attention_function(forward, backward):
    """The fused attention Function with another forward and backward while
    the block runs; K5 counts its launches on the module's name
    fused_attention_bwd, so the stand-in there carries the count."""
    saved = attention._forward, attention.fused_attention_bwd

    def stand_in(*args):
        return backward(*args)

    stand_in.launches = saved[1].launches
    attention._forward, attention.fused_attention_bwd = forward, stand_in
    try:
        yield
    finally:
        attention._forward, attention.fused_attention_bwd = saved
        saved[1].launches = stand_in.launches


def _finetune_steps(dev):
    """One finetune step (two passes over 4 chunks a side, remat) from the
    same f32 master and batch per attention path: {name: (loss, grads,
    (K1, K5) launches)}. "kernel" runs K1 and K5, "plain_bwd" K1 and K5's
    plain version in the same Function, "fault" K1 and a K5 that drops a
    query tile, "eager" and "eager_f32" attention_impl="eager" in bf16 and
    f32."""
    from protein_clip_tpu_torch.train import finetune

    mcfg, esm_params = _tiny_t30_like(dev)
    rng = np.random.default_rng(1)
    aas = list("LAGVSERTIDPKQNFYMHWC")
    peps = ["".join(rng.choice(aas, int(n))) for n in rng.integers(8, 30, 32)]
    recs = ["".join(rng.choice(aas, int(n))) for n in rng.integers(30, 90, 32)]
    batch = {k: v.to(dev) for k, v in
             clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs).items()}
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(1), device=dev)
    k1, k5 = attention._forward, attention.fused_attention_bwd
    paths = {"kernel": ("fused", torch.bfloat16, k1, k5),
             "plain_bwd": ("fused", torch.bfloat16, k1, attention.attention_reference_bwd),
             "fault": ("fused", torch.bfloat16, k1, _drop_last_query_tile(k5)),
             "eager": ("eager", torch.bfloat16, k1, k5),
             "eager_f32": ("eager", torch.float32, k1, k5)}
    out = {}
    for name, (impl, dtype, fwd, bwd) in paths.items():
        esm_cfg = dataclasses.replace(mcfg.esm, attention_impl=impl, compute_dtype=dtype)
        cfg = clip_engine.EngineConfig(model=dataclasses.replace(mcfg, esm=esm_cfg),
                                       batch_size=32, accumulated_batches=1, num_chunks=4)
        params = finetune.init_params(esm_params, _clone(heads0))
        state = _capturing(finetune.make_optimizer(cfg).init(params))
        before = (attention.fused_attention.launches, k5.launches)
        with _attention_function(fwd, bwd):
            _, _, loss = finetune.make_train_step(cfg)(params, state, {}, batch, None)
        torch.cuda.synchronize()
        out[name] = (float(loss), state.grads,
                     (attention.fused_attention.launches - before[0], k5.launches - before[1]))
    return out


def _worst_gap(a, b):
    """The largest max|a - b| / max|b| over the leaves."""
    return max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(a, b))


def test_finetune_step_runs_k1_and_k5_and_matches_eager(dev):
    """One finetune step through K1/K5. Per layer K1 launches once per
    pass-1 forward and twice per pass-2 chunk (forward and recompute), K5
    once per pass-2 chunk. Against the same step through K1 and K5's plain
    version, every leaf's gradient within FT_K5_TOL of its largest entry
    and the loss within FT_LOSS_TOL, and a K5 that drops the last query tile
    of its dk/dv loop fails that. Against eager autograd, which rounds
    elsewhere (P to bf16 before P.V, dP rather than dS to bf16), each leaf
    is held in L2 norm to |kernel - eager| <= 2 |eager - f32| + 5e-2 |f32|,
    and the loss to 2 |eager - f32| + 1e-4 |f32|, with the eager step in
    f32 as the reference: with random weights the attention is near
    uniform, where bf16 rounds every probability of a row alike, so each
    path carries its own bias of up to 2^-9 per layer."""
    out = _finetune_steps(dev)
    chunks, layers = 2 * 4, 2
    assert out["kernel"][2] == (3 * chunks * layers, chunks * layers)
    assert out["plain_bwd"][2] == (3 * chunks * layers, 0)
    assert out["fault"][2] == (3 * chunks * layers, 2 * chunks * layers)
    assert out["eager"][2] == out["eager_f32"][2] == (0, 0)
    (lk, gk, _), (lp, gp, _) = out["kernel"], out["plain_bwd"]
    assert abs(lk - lp) <= FT_LOSS_TOL * abs(lp)
    assert _worst_gap(gk, gp) <= FT_K5_TOL
    assert _worst_gap(out["fault"][1], gp) > FT_K5_TOL
    (le, ge, _), (lf, gf, _) = out["eager"], out["eager_f32"]
    assert abs(lk - le) <= 2 * abs(le - lf) + 1e-4 * abs(lf)
    for a, b, f in zip(gk, ge, gf):
        assert float((a - b).norm()) <= 2 * float((b - f).norm()) + 5e-2 * float(f.norm())


def test_chunk_seeds_on_a_cuda_generator_need_no_sync(dev):
    """The unfrozen step's per-chunk dropout seeds come from the CUDA
    generator's host state: the same state gives the same seeds, and each
    call moves the Philox offset on, so the next step draws others."""
    from protein_clip_tpu_torch.train import finetune

    gen = torch.Generator(device=dev).manual_seed(5)
    first = finetune._chunk_seeds(gen, 16)
    assert gen.get_offset() == 4
    second = finetune._chunk_seeds(gen, 16)
    again = finetune._chunk_seeds(torch.Generator(device=dev).manual_seed(5), 16)
    assert first == again != second
    assert all(isinstance(s, int) for side in first + second for s in side)
    assert len({s for side in first for s in side}) == 32


# ---------------------------------------------------------------------------
# P1 (dense_mm) and K6 (ffn_gelu)
# ---------------------------------------------------------------------------

# P1 s8 -> s32 is exact: equal to its plain version to the bit. bf16 -> f32:
# the same f32 products summed in another order, |err| <= MM_BF16_TOL times
# |x| @ |w| (a sum's rounding scale); a kernel that drops its last k-tile
# misses 16 of K products, past it by orders of magnitude.
MM_BF16_TOL = 1e-5
# The t30_150M linear layers (K, M): q/k/v/o, wi, wo.
T30_LAYERS = ((640, 640), (640, 2560), (2560, 640))
# K6 against its plain version, both bf16: per element |err| <= FFN_ULPS bf16
# ulps of max(|x @ w|, |b|, |ref|), and at most FFN_SHARE of the outputs
# differ at all. Sum order flips a rounding of x @ w in ~2e-5 of them; a
# kernel that skips the bf16 rounding before the bias, or adds the bias
# without rounding the sum, changes 23-26% (emulated on the plain version).
FFN_ULPS, FFN_SHARE = 4, 1e-3


def _s8(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)


def _drop_last_k_tile(x, tile):
    """x with its last k-tile of `tile` columns zeroed: what a main loop that
    drops its last k-tile computes (a planted fault)."""
    cut = x.clone()
    cut[:, (x.shape[1] - 1) // tile * tile:] = 0
    return cut


@pytest.mark.parametrize("N,K,M", [(n, k, m) for n in (1, 37, 256) for k in (32, 640)
                                   for m in (64, 640)]
                         + [(n, k, m) for n in (128, 1000) for k, m in T30_LAYERS])
def test_dense_mm_s8_equals_plain(dev, N, K, M):
    x, w = _s8((N, K), dev, N + K), _s8((K, M), dev, M)
    before = dense_mm.mm.launches
    got = dense_mm.mm(x, w, torch.int32)
    torch.cuda.synchronize()
    assert dense_mm.mm.launches == before + 1
    want = dense_mm.mm_reference(x, w, torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert not torch.equal(dense_mm.mm(_drop_last_k_tile(x, 64), w, torch.int32), want)


@pytest.mark.parametrize("value", [127, -127, -128])
def test_dense_mm_s8_at_the_extremes(dev, value):
    K = 2560
    x = torch.full((130, K), value, dtype=torch.int8, device=dev)
    x[1::3] = -128
    w = torch.full((K, 640), value, dtype=torch.int8, device=dev)
    w[:, 1::2] = 127
    got = dense_mm.mm(x, w, torch.int32)
    want = dense_mm.mm_reference(x, w, torch.int32)
    assert torch.equal(got, want)
    assert int(want.abs().max()) >= K * 127 * 127


def _mm_bf16_gap(x, w, got):
    want = dense_mm.mm_reference(x, w, torch.float32)
    scale = torch.matmul(x.float().abs(), w.float().abs())
    return float(((got - want).abs() / scale.clamp(min=1e-30)).max())


@pytest.mark.parametrize("N,K,M", [(1, 16, 8), (37, 640, 640), (300, 2560, 640),
                                   (129, 640, 2560)])
def test_dense_mm_bf16_within_bound(dev, N, K, M):
    g = torch.Generator(device=dev).manual_seed(N)
    x = torch.randn(N, K, generator=g, device=dev).bfloat16()
    w = (0.05 * torch.randn(K, M, generator=g, device=dev)).bfloat16()
    got = dense_mm.mm(x, w, torch.float32)
    assert got.dtype == torch.float32
    assert _mm_bf16_gap(x, w, got) <= MM_BF16_TOL
    if K > 32:
        assert _mm_bf16_gap(x, w, dense_mm.mm(_drop_last_k_tile(x, 32), w, torch.float32)) \
            > MM_BF16_TOL


def test_dense_mm_refuses_what_the_kernel_does_not_take(dev):
    x, w = _s8((4, 64), dev, 0), _s8((64, 16), dev, 1)
    with pytest.raises(ValueError, match="multiple of 32"):
        dense_mm.mm(x[:, :48].contiguous(), w[:48].contiguous(), torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        dense_mm.mm(x, w[:, :12].contiguous(), torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        dense_mm.mm(x, w.t().contiguous().t(), torch.int32)
    with pytest.raises(TypeError, match="int8 x int8"):
        dense_mm.mm(x, w.bfloat16(), torch.int32)
    with pytest.raises(ValueError, match="on cpu"):
        dense_mm.mm(x, w.cpu(), torch.int32)


def _ffn_inputs(N, H, M, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(N, H, generator=g, device=dev).bfloat16(),
            (torch.randn(H, M, generator=g, device=dev) / H ** 0.5).bfloat16(),
            (0.5 * torch.randn(M, generator=g, device=dev)).bfloat16())


def _ffn_gap(x, w, b, got, mode):
    """(largest error in bf16 ulps of max(|x @ w|, |b|, |ref|), share of
    outputs that differ)."""
    ref = ffn.dense_gelu_reference(x, w, b, mode).float()
    scale = torch.maximum(torch.matmul(x.float(), w.float()).abs(), b.float().abs()[None])
    _, e = torch.frexp(torch.maximum(scale, ref.abs()))
    err = (got.float() - ref).abs()
    return float((err / torch.ldexp(torch.ones_like(ref), e - 8)).max()), \
        float((err > 0).float().mean())


@pytest.mark.parametrize("mode", ["erf", "tanh"])
@pytest.mark.parametrize("N,H,M", [(64, 640, 2560), (128, 640, 2560), (3072, 640, 2560),
                                   (33, 48, 40)])
def test_ffn_gelu_matches_plain(dev, N, H, M, mode):
    x, w, b = _ffn_inputs(N, H, M, dev)
    before = ffn.dense_gelu.launches
    got = ffn.dense_gelu(x, w, b, mode)
    torch.cuda.synchronize()
    assert ffn.dense_gelu.launches == before + 1 and got.dtype == torch.bfloat16
    ulps, share = _ffn_gap(x, w, b, got, mode)
    assert ulps <= FFN_ULPS and share <= FFN_SHARE, (ulps, share)
    fault = ffn.dense_gelu(_drop_last_k_tile(x, 32), w, b, mode)
    assert _ffn_gap(x, w, b, fault, mode)[0] > FFN_ULPS


def test_ffn_gelu_check_sees_a_skipped_rounding(dev):
    """The plain version without the bf16 rounding before the bias, and
    with the bias added to the unrounded sum: each fails FFN_SHARE."""
    x, w, b = _ffn_inputs(256, 640, 2560, dev)
    acc = torch.matmul(x.float(), w.float())
    for z in ((acc + b.float()).bfloat16(), acc.bfloat16().float() + b.float()):
        out = ffn._gelu_f32(z.float(), "erf").bfloat16()
        assert _ffn_gap(x, w, b, out, "erf")[1] > 10 * FFN_SHARE


def test_ffn_gelu_backward_is_the_plain_composition(dev):
    x, w, b = (t.requires_grad_(True) for t in _ffn_inputs(64, 640, 2560, dev))
    g = torch.randn(64, 2560, device=dev).bfloat16()
    got = torch.autograd.grad(ffn.dense_gelu(x, w, b, "erf"), (x, w, b), g)
    want = torch.autograd.grad(ffn.dense_gelu_reference(x, w, b, "erf"), (x, w, b), g)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_ffn_gelu_refuses_what_the_kernel_does_not_take(dev):
    x, w, b = _ffn_inputs(8, 64, 64, dev)
    with pytest.raises(TypeError, match="bfloat16"):
        ffn.dense_gelu(x.float(), w.float(), b.float(), "erf")
    with pytest.raises(ValueError, match="fits"):
        ffn.dense_gelu(x[:, :40].contiguous(), w[:40].contiguous(), b, "erf")
    with pytest.raises(ValueError, match="mode"):
        ffn.dense_gelu(x, w, b, "relu")


def test_ffn_gate_raises_on_a_shape_the_kernel_does_not_take(dev, monkeypatch):
    """Under PCT_FFN_PALLAS=1 a CUDA wi of a shape K6 does not take (H no
    multiple of 16) raises; it never runs the plain version on the card."""
    monkeypatch.setenv("PCT_FFN_PALLAS", "1")
    cfg = esm2.ESM2Config.tiny()
    x, w, b = _ffn_inputs(8, 40, 64, dev)
    before = ffn.dense_gelu.launches
    with pytest.raises(ValueError, match="fits"):
        esm2._wi_gelu(x.view(2, 4, 40), {"w": w, "b": b}, cfg)
    assert ffn.dense_gelu.launches == before


def _t30_width(dev, layers=2):
    cfg = esm2.ESM2Config(num_layers=layers, compute_dtype=torch.bfloat16)
    params = esm2.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dtype=torch.bfloat16, device=dev)
    ids = torch.randint(4, 24, (3, 100), device=dev)
    mask = torch.ones(3, 100, dtype=torch.int32, device=dev)
    mask[2, 60:] = 0
    ids[2, 60:] = 1
    return cfg, params, ids, mask


def test_int8_forward_runs_p1_six_times_a_layer_and_equals_plain_mm(dev, monkeypatch):
    cfg, params, ids, mask = _t30_width(dev)
    cfg = dataclasses.replace(cfg, gelu="tanh")
    q = esm2.quantize_params(params)
    before = (dense_mm.mm.launches, attention.fused_attention.launches)
    with torch.inference_mode():
        got = esm2.forward(q, ids, mask, cfg)
    assert (dense_mm.mm.launches - before[0], attention.fused_attention.launches - before[1]) \
        == (6 * cfg.num_layers, cfg.num_layers)
    monkeypatch.setattr(dense_mm, "mm", dense_mm.mm_reference)
    with torch.inference_mode():
        want = esm2.forward(q, ids, mask, cfg)
    assert torch.equal(got, want)


def test_ffn_gate_runs_k6_once_a_layer(dev, monkeypatch):
    cfg, params, ids, mask = _t30_width(dev)
    with torch.inference_mode():
        off = esm2.forward(params, ids, mask, cfg)
        monkeypatch.setenv("PCT_FFN_PALLAS", "1")
        before = ffn.dense_gelu.launches
        on = esm2.forward(params, ids, mask, cfg)
    assert ffn.dense_gelu.launches - before == cfg.num_layers
    valid = mask.bool()
    cos = torch.nn.functional.cosine_similarity(on[valid].float(), off[valid].float(), dim=-1)
    assert float(cos.min()) >= 0.999


def test_finetune_step_under_the_ffn_gate(dev, monkeypatch):
    """One finetune step of a 2-layer backbone with PCT_FFN_PALLAS=1 against
    the gate off, from the same weights and batch. K6's backward is the
    plain composition, so the gradients differ only through K6's forward
    against cuBLAS's bf16 product (a few bf16 flips): every leaf within
    FT_K5_TOL of its largest entry, the loss within 1e-3 relative. A K6
    whose main loop drops its last k-tile (emulated by zeroing x's last 32
    columns) must fail that. On an H100 the loss agrees to the bit and the
    worst leaf reads 0.0050, not 0: the plain composition's backward runs
    its products in f32 where the gate-off path's runs bf16 GEMMs. The
    planted fault reads 1.46."""
    from protein_clip_tpu_torch.train import finetune

    mcfg, esm_params = _tiny_t30_like(dev)
    rng = np.random.default_rng(2)
    aas = list("LAGVSERTIDPKQNFYMHWC")
    peps = ["".join(rng.choice(aas, int(n))) for n in rng.integers(8, 30, 32)]
    recs = ["".join(rng.choice(aas, int(n))) for n in rng.integers(30, 90, 32)]
    batch = {k: v.to(dev) for k, v in
             clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs).items()}
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(1), device=dev)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=32, accumulated_batches=1,
                                   num_chunks=4)
    kernel_forward = ffn._forward

    def fault(x, w, b, mode):
        return kernel_forward(_drop_last_k_tile(x, 32), w, b, mode)

    out = {}
    for name, gate, forward in (("off", "0", kernel_forward), ("on", "1", kernel_forward),
                                ("fault", "1", fault)):
        monkeypatch.setenv("PCT_FFN_PALLAS", gate)
        monkeypatch.setattr(ffn, "_forward", forward)
        params = finetune.init_params(esm_params, _clone(heads0))
        state = _capturing(finetune.make_optimizer(cfg).init(params))
        before = ffn.dense_gelu.launches
        _, _, loss = finetune.make_train_step(cfg)(params, state, {}, batch, None)
        torch.cuda.synchronize()
        out[name] = (float(loss), state.grads, ffn.dense_gelu.launches - before)
    # pass 1: 1 per layer per chunk; pass 2: forward and remat recompute
    assert out["off"][2] == 0 and out["on"][2] == 3 * 2 * 4 * mcfg.esm.num_layers
    loss_gap = abs(out["on"][0] - out["off"][0]) / abs(out["off"][0])
    gap, fault_gap = (_worst_gap(out[k][1], out["off"][1]) for k in ("on", "fault"))
    print(f"K6 gate finetune step: loss gap {loss_gap:.3g}, worst leaf {gap:.4g}, "
          f"planted fault {fault_gap:.4g} (tolerance {FT_K5_TOL:g})")
    assert loss_gap <= 1e-3
    assert gap <= FT_K5_TOL < fault_gap
