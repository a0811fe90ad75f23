"""ESM-2 encoder in PyTorch: the port of ``protein_clip_tpu/models/esm2.py``.

Parameters are a nested dict of tensors in the TPU package's layout (layers
stacked on a leading layer axis, linear weights ``(in, out)``), so
``train/checkpoint.from_numpy_tree`` carries that package's weights over as
they are, and ``convert_hf_state_dict`` maps a HF ``EsmModel`` /
``EsmForMaskedLM`` state dict onto it. The precision contract is the same:
bf16 (or f32) operands with f32 accumulation in the matmuls, LayerNorm and
softmax in f32, q scaled by dh^-0.5 before RoPE, ESM's exact-erf GELU by
default, and token dropout rescaled by the observed mask ratio over each
sequence's true length.

Linear layers: ``{"w", "b"}`` leaves run in the compute dtype;
``{"w_q", "w_s", "b"}`` leaves from ``quantize_params`` (``--esm-dtype
int8``) run w8a8 through the s8 tensor-core kernel P1 (``ops/dense_mm``).
Under ``PCT_FFN_PALLAS=1`` the FFN's wi + gelu runs as the fused kernel K6
(``ops/ffn``), in bf16 or f32.

Tensor parallelism (``parallel/sharding.py``): with ``cfg.model_axis`` set
the layer weights are this rank's Megatron slices, and the forward reads
its head count from q's width. The LayerNorm's output enters the
column-parallel q, k, v and wi through ``copy_to_model`` (its cotangent
summed over the model group), K1 and K5 (and K6 under the gate) run on the
rank's heads and FFN columns, and the row-parallel o and wo form f32
partial products (bf16 operands through P1's bf16 -> f32 entry point; f32
operands in f32), summed over the model group in f32 and rounded once,
then the bias: the TPU package's ``_dense`` contract under GSPMD. An int8
row-parallel linear takes its per-token scale from the whole row (an
all-reduce MAX), sums its s32 partials exactly (an int32 all-reduce) and
dequantises after, so it equals the one-device int8 forward to the bit.
Without ``model_axis`` the forward is the one-device one.

Attention: with ``attention_impl="fused"`` on CUDA tensors each layer calls
the hand-written kernels (``ops/attention.fused_attention``: K1 forward, K5
backward), for every sequence length; the kernels take bf16 and f32 at
every ESM-2 head dim (16, 24, 32, 64, 128), and ``forward`` raises on CUDA
for another head dim unless it asks for ``attention_impl="eager"``.
Otherwise the eager form runs: f32 scores plus an
additive f32-min key mask, f32 softmax, probabilities cast to the compute
dtype, P.V in f32. The two differ only at pad query rows (the kernel's are
a uniform average, the eager ones attend to the valid keys), which pooling
drops.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import attention, dense_mm, ffn
from ..parallel import distributed
from ..utils.device import resolve_device

Params = dict


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = 33
    hidden_size: int = 640
    num_layers: int = 30
    num_heads: int = 20
    intermediate_size: int = 2560
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    mask_token_id: int = 32
    token_dropout: bool = True
    # dtype of the matmul operands and activations; accumulation is f32.
    compute_dtype: torch.dtype = torch.float32
    # "fused": the CUDA kernel K1 on CUDA tensors, which takes bf16 and
    # f32 at every family's head_dim; "eager": einsum + masked softmax, the
    # plain version, on any device.
    attention_impl: str = "fused"
    # FFN gelu: "erf" (ESM's exact form, the parity contract) or "tanh".
    # The PCT_GELU A/B knob is read once, here at construction, as in the
    # TPU package: an explicit gelu= wins over a stale PCT_GELU.
    gelu: str = dataclasses.field(default_factory=lambda: os.environ.get("PCT_GELU", "erf"))
    # tensor parallelism: the mesh's 'model' axis (``parallel.distributed.
    # ModelAxis``) when the layer weights are this rank's Megatron slices
    # (``parallel/sharding.py``), None for the one-device forward
    model_axis: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def t30_150M(**over) -> "ESM2Config":
        """facebook/esm2_t30_150M_UR50D."""
        return ESM2Config(**over)

    @staticmethod
    def t6_8M(**over) -> "ESM2Config":
        """facebook/esm2_t6_8M_UR50D."""
        return ESM2Config(hidden_size=320, num_layers=6, num_heads=20,
                          intermediate_size=1280, **over)

    @staticmethod
    def t12_35M(**over) -> "ESM2Config":
        """facebook/esm2_t12_35M_UR50D."""
        return ESM2Config(hidden_size=480, num_layers=12, num_heads=20,
                          intermediate_size=1920, **over)

    @staticmethod
    def t33_650M(**over) -> "ESM2Config":
        """facebook/esm2_t33_650M_UR50D."""
        return ESM2Config(hidden_size=1280, num_layers=33, num_heads=20,
                          intermediate_size=5120, **over)

    @staticmethod
    def t36_3B(**over) -> "ESM2Config":
        """facebook/esm2_t36_3B_UR50D (head_dim 64)."""
        return ESM2Config(hidden_size=2560, num_layers=36, num_heads=40,
                          intermediate_size=10240, **over)

    @staticmethod
    def t48_15B(**over) -> "ESM2Config":
        """facebook/esm2_t48_15B_UR50D (head_dim 128)."""
        return ESM2Config(hidden_size=5120, num_layers=48, num_heads=40,
                          intermediate_size=20480, **over)

    @staticmethod
    def tiny(**over) -> "ESM2Config":
        """Tiny config for tests (head_dim 16)."""
        return ESM2Config(hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128, **over)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_spec(cfg: ESM2Config) -> Params:
    """Nested dict of (shape, init) leaves; init is "normal", "zeros" or "ones"."""
    H, I, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size

    def lin(fan_in, fan_out):
        return {"w": ((L, fan_in, fan_out), "normal"), "b": ((L, fan_out), "zeros")}

    def ln():
        return {"w": ((L, H), "ones"), "b": ((L, H), "zeros")}

    return {
        "embed": {"word": ((V, H), "normal")},
        "layers": {
            "attn": {"q": lin(H, H), "k": lin(H, H), "v": lin(H, H), "o": lin(H, H),
                     "ln": ln()},
            "ffn": {"wi": lin(H, I), "wo": lin(I, H), "ln": ln()},
        },
        "final_ln": {"w": ((H,), "ones"), "b": ((H,), "zeros")},
    }


def _map_spec(spec, fn):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn) for k, v in spec.items()}
    return fn(*spec)


def init_params(cfg: ESM2Config, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Random init (normal, std 0.02, like HF's initializer_range), drawn
    from ``generator`` on its own device and moved to ``device``."""
    device = resolve_device(device)
    gen_device = generator.device

    def make(shape, init):
        if init == "normal":
            t = 0.02 * torch.randn(shape, generator=generator, device=gen_device)
        elif init == "ones":
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        return t.to(device=device, dtype=dtype)

    return _map_spec(_param_spec(cfg), make)


def init_lm_head(cfg: ESM2Config, generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 device="cuda") -> Params:
    """ESM's MLM head, as the TPU package's ``init_lm_head``: dense (H, H)
    drawn normal with std 0.02 from ``generator`` on its own device, its
    bias 0, LayerNorm 1 and 0, and the tied decoder's bias (V,) 0; the
    decoder's weight is the backbone's token embedding (``lm_logits``)."""
    device = resolve_device(device)
    H, V = cfg.hidden_size, cfg.vocab_size
    w = 0.02 * torch.randn((H, H), generator=generator, device=generator.device)
    return {"dense": {"w": w.to(device=device, dtype=dtype),
                      "b": torch.zeros(H, dtype=dtype, device=device)},
            "ln": {"w": torch.ones(H, dtype=dtype, device=device),
                   "b": torch.zeros(H, dtype=dtype, device=device)},
            "bias": torch.zeros(V, dtype=dtype, device=device)}


def abstract_params(cfg: ESM2Config, dtype: torch.dtype = torch.float32) -> Params:
    """The parameter structure as meta tensors (shapes and dtypes, no data)."""
    return _map_spec(_param_spec(cfg),
                     lambda shape, _: torch.empty(shape, dtype=dtype, device="meta"))


def _layers(tree: Params, n: int) -> list[Params]:
    """The per-layer trees of a tree stacked on a leading layer axis. One
    ``unbind`` per leaf, so under autograd each leaf's layer gradients come
    back stacked by one op, not as n zero-padded full-size gradients."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every leaf in ``dtype`` (``esm2.cast_params`` of the TPU package);
    differentiable, so a cast of f32 master weights routes the compute
    dtype's gradients back into them in f32."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


@torch.no_grad()
def quantize_params(params: Params) -> Params:
    """Post-training int8 quantisation of the big linear weights
    (``--esm-dtype int8``), as the TPU package's ``quantize_params``:
    symmetric per-output-channel scales s = max(max|w| over ``in``, 1e-12) /
    127 and w_q = round(w / s) (half to even) for attention q, k, v, o and
    FFN wi, wo, one layer at a time in f32. Embeddings, LayerNorms and
    biases stay as they are; activations are quantised per token in
    ``_dense``. Not a parity path: hidden states drift by int8 rounding."""

    def q(lp):
        w_q, w_s = [], []
        for w_l in lp["w"].unbind(0):          # (in, out), one layer at a time
            w = w_l.float()
            s = w.abs().amax(0).clamp(min=1e-12) / 127.0
            w_q.append(torch.round(w / s).to(torch.int8))
            w_s.append(s)
        return {"w_q": torch.stack(w_q), "w_s": torch.stack(w_s), "b": lp["b"]}

    layers = params["layers"]
    return {
        "embed": params["embed"],
        "layers": {
            "attn": {k: q(v) if k in ("q", "k", "v", "o") else v
                     for k, v in layers["attn"].items()},
            "ffn": {k: q(v) if k in ("wi", "wo") else v for k, v in layers["ffn"].items()},
        },
        "final_ln": params["final_ln"],
    }


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

_HF_LAYER = "encoder.layer.{i}."
# (our leaf path, HF name within a layer, transposed to (in, out))
_HF_LAYER_LEAVES = (
    (("attn", "q", "w"), "attention.self.query.weight", True),
    (("attn", "q", "b"), "attention.self.query.bias", False),
    (("attn", "k", "w"), "attention.self.key.weight", True),
    (("attn", "k", "b"), "attention.self.key.bias", False),
    (("attn", "v", "w"), "attention.self.value.weight", True),
    (("attn", "v", "b"), "attention.self.value.bias", False),
    (("attn", "o", "w"), "attention.output.dense.weight", True),
    (("attn", "o", "b"), "attention.output.dense.bias", False),
    (("attn", "ln", "w"), "attention.LayerNorm.weight", False),
    (("attn", "ln", "b"), "attention.LayerNorm.bias", False),
    (("ffn", "wi", "w"), "intermediate.dense.weight", True),
    (("ffn", "wi", "b"), "intermediate.dense.bias", False),
    (("ffn", "wo", "w"), "output.dense.weight", True),
    (("ffn", "wo", "b"), "output.dense.bias", False),
    (("ffn", "ln", "w"), "LayerNorm.weight", False),
    (("ffn", "ln", "b"), "LayerNorm.bias", False),
)


def hf_shapes(cfg: ESM2Config) -> dict[str, tuple[int, ...]]:
    """The backbone's tensors in a HF ESM-2 state dict (without the ``esm.``
    prefix) and their shapes for ``cfg``: torch's (out, in) for linear
    weights."""
    spec = _param_spec(cfg)
    shapes = {"embeddings.word_embeddings.weight": spec["embed"]["word"][0],
              "encoder.emb_layer_norm_after.weight": spec["final_ln"]["w"][0],
              "encoder.emb_layer_norm_after.bias": spec["final_ln"]["b"][0]}
    for path, name, transpose in _HF_LAYER_LEAVES:
        shape = spec["layers"][path[0]][path[1]][path[2]][0][1:]
        for i in range(cfg.num_layers):
            shapes[_HF_LAYER.format(i=i) + name] = shape[::-1] if transpose else shape
    return shapes


def _out(arr: np.ndarray, device):
    return arr if device is None else torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device))


def convert_hf_state_dict(state_dict: dict[str, np.ndarray], cfg: ESM2Config,
                          dtype=np.float32, device=None) -> Params:
    """Map a HF EsmModel / EsmForMaskedLM state dict (numpy arrays; the
    ``esm.`` prefix stripped) onto the stacked tree, as the TPU package's
    ``convert_hf_state_dict``: linear weights transposed from torch's (out,
    in) to (in, out), each per-layer tensor stacked over the layers, every
    leaf in ``dtype``. Keys the backbone does not read are ignored. A missing
    key, or a tensor whose shape is not ``cfg``'s, raises naming the key.
    The leaves are numpy arrays, or with ``device`` tensors there."""
    sd = {k.removeprefix("esm."): v for k, v in state_dict.items()}
    for key, shape in hf_shapes(cfg).items():
        if key not in sd:
            raise KeyError(f"HF state dict has no {key} (needed by {cfg.num_layers}-layer "
                           f"hidden-{cfg.hidden_size} ESM-2)")
        if tuple(sd[key].shape) != tuple(shape):
            raise ValueError(f"HF tensor {key} has shape {tuple(sd[key].shape)}, the ESM-2 "
                             f"config wants {tuple(shape)}")

    def leaf(key, transpose=False):
        a = np.asarray(sd[key], dtype=dtype)
        return a.T if transpose else a

    layers: Params = {}
    for (part, name, wb), hf_name, transpose in _HF_LAYER_LEAVES:
        stacked = np.stack([leaf(_HF_LAYER.format(i=i) + hf_name, transpose)
                            for i in range(cfg.num_layers)])
        layers.setdefault(part, {}).setdefault(name, {})[wb] = _out(stacked, device)
    return {
        "embed": {"word": _out(leaf("embeddings.word_embeddings.weight"), device)},
        "layers": layers,
        "final_ln": {"w": _out(leaf("encoder.emb_layer_norm_after.weight"), device),
                     "b": _out(leaf("encoder.emb_layer_norm_after.bias"), device)},
    }


def convert_hf_lm_head(state_dict: dict[str, np.ndarray], device=None) -> Params:
    """The MLM head of a HF EsmForMaskedLM state dict, as the TPU package's
    ``convert_hf_lm_head``: {dense {w (in, out), b}, ln {w, b}, bias}."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    return {
        "dense": {"w": _out(sd["lm_head.dense.weight"].T, device),
                  "b": _out(sd["lm_head.dense.bias"], device)},
        "ln": {"w": _out(sd["lm_head.layer_norm.weight"], device),
               "b": _out(sd["lm_head.layer_norm.bias"], device)},
        "bias": _out(sd["lm_head.bias"], device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, w, b, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def _gelu(x, mode: str = "erf"):
    if mode == "tanh":
        return F.gelu(x, approximate="tanh")
    x32 = x.float()
    return (x32 * 0.5 * (1.0 + torch.erf(x32 / math.sqrt(2.0)))).to(x.dtype)


def _rope_tables(seq_len: int, head_dim: int, dtype, device):
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                      # (T, dh/2)
    emb = np.concatenate([freqs, freqs], axis=-1)      # (T, dh)
    return (torch.from_numpy(np.cos(emb)).to(device=device, dtype=dtype),
            torch.from_numpy(np.sin(emb)).to(device=device, dtype=dtype))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rope(x, cos, sin):
    # x: (B, T, heads, dh); cos/sin: (T, dh) shared positions, or (B, T, dh)
    # per-token positions (packed rows)
    if cos.dim() == 2:
        return x * cos[None, :, None, :] + _rotate_half(x) * sin[None, :, None, :]
    return x * cos[:, :, None, :] + _rotate_half(x) * sin[:, :, None, :]


def _dense(x, lp):
    """(B, T, in) @ layer params -> (B, T, out), dispatching on the params.

    ``{"w", "b"}``: bf16 or f32 operands, f32 accumulation, result in the
    operands' dtype, then the bias. ``{"w_q", "w_s", "b"}`` (from
    ``quantize_params``): w8a8, with a dynamic symmetric int8 scale per token
    (xs = max|x| / 127, at least 1e-6 / 127), round half to even, the s8 x s8
    -> s32 product through P1, dequantised in f32 by xs * w_s, cast to x's
    dtype, then the bias.
    """
    if "w_q" in lp:
        x32 = x.float()
        xs = x32.abs().amax(-1, keepdim=True).clamp(min=1e-6) * (1.0 / 127.0)
        xq = torch.round(x32 / xs).to(torch.int8)
        w_q = lp["w_q"]
        y = dense_mm.mm(xq.reshape(-1, w_q.shape[0]), w_q, torch.int32)
        y = y.view(*x.shape[:-1], w_q.shape[1])
        return (y.float() * xs * lp["w_s"]).to(x.dtype) + lp["b"]
    return torch.matmul(x, lp["w"]) + lp["b"]


class _PartialMM(torch.autograd.Function):
    """(N, K) x (K, M) bf16 -> f32 through P1 (``dense_mm.mm``); its
    backward takes the cotangent in bf16 (it is the f32 cast of one) into
    bf16 products, the arithmetic of the one-device bf16 linear's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dense_mm.mm(x, w, torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def _row_dense(x, lp, axis):
    """A row-parallel linear (o, wo) on this rank's slice of its input: the
    partial product summed over the model group, then the bias.
    ``{"w", "b"}``: f32 partials (bf16 operands through P1), summed in f32
    and rounded to x's dtype once. ``{"w_q", "w_s", "b"}``: the whole row's
    per-token scale (all-reduce MAX), s8 x s8 -> s32 partials through P1
    summed in int32, then ``_dense``'s dequant: exact."""
    if "w_q" in lp:
        x32 = x.float()
        xs = distributed.all_max(x32.abs().amax(-1, keepdim=True), axis)
        xs = xs.clamp(min=1e-6) * (1.0 / 127.0)
        xq = torch.round(x32 / xs).to(torch.int8)
        w_q = lp["w_q"]
        y = distributed.all_sum(dense_mm.mm(xq.reshape(-1, w_q.shape[0]), w_q, torch.int32), axis)
        y = y.view(*x.shape[:-1], w_q.shape[1])
        return (y.float() * xs * lp["w_s"]).to(x.dtype) + lp["b"]
    w = lp["w"]
    x2 = x.reshape(-1, w.shape[0]).contiguous()
    part = (_PartialMM.apply(x2, w) if x.dtype == torch.bfloat16
            else torch.matmul(x2.float(), w.float()))
    y = distributed.reduce_from_model(part, axis)
    return y.view(*x.shape[:-1], w.shape[1]).to(x.dtype) + lp["b"]


def _out_dense(x, lp, axis):
    """o and wo: the one-device linear, or the row-parallel one on a mesh."""
    return _dense(x, lp) if axis is None else _row_dense(x, lp, axis)


def _into_columns(h, axis):
    """A replicated activation entering the column-parallel linears."""
    return h if axis is None else distributed.copy_to_model(h, axis)


def _out_width(lp) -> int:
    return (lp["w"] if "w" in lp else lp["w_q"]).shape[-1]


def _attention_block(x, p, mask_bias, segments, cos, sin, cfg: ESM2Config):
    """Pre-LN attention residual block in the (B, T, heads, dh) layout, on
    the heads q's width holds (all, or a rank's share under tensor
    parallelism). ``segments`` is (B, T) int32: the 0/1 mask of padded
    rows, or the segment ids of packed rows; ``mask_bias`` its additive f32
    form for the eager path, None where K1 runs."""
    B, T, _ = x.shape
    dh = cfg.head_dim
    nh = _out_width(p["q"]) // dh
    h = _into_columns(_layer_norm(x, p["ln"]["w"], p["ln"]["b"], cfg.layer_norm_eps),
                      cfg.model_axis)
    q = _dense(h, p["q"]).view(B, T, nh, dh) * (dh ** -0.5)  # ESM scales q before RoPE
    k = _dense(h, p["k"]).view(B, T, nh, dh)
    v = _dense(h, p["v"]).view(B, T, nh, dh)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)

    ctx = _attend(q, k, v, mask_bias, segments, cfg)
    return x + _out_dense(ctx.reshape(B, T, nh * dh), p["o"], cfg.model_axis)


def _uses_kernel(x, cfg: ESM2Config) -> bool:
    return cfg.attention_impl == "fused" and x.is_cuda


def _attend(q, k, v, mask_bias, segments, cfg: ESM2Config):
    """(B, T, heads, dh) attention context: K1 with ``attention_impl="fused"``
    on CUDA tensors (a pad query row averages v over all T keys), else the
    eager form. On padded rows the eager form masks keys only (a pad query
    row attends to the valid keys, as the TPU package's eager path does), so
    the two differ at pad rows, which pooling drops; on packed rows it masks
    query and key (a gap query row is fully masked and softmaxes to the
    uniform average), so the two agree everywhere."""
    if _uses_kernel(q, cfg):
        return attention.fused_attention(q, k, v, segments)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) + mask_bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(q.dtype)


def _ffn_block(x, p, cfg: ESM2Config):
    h = _into_columns(_layer_norm(x, p["ln"]["w"], p["ln"]["b"], cfg.layer_norm_eps),
                      cfg.model_axis)
    h = _wi_gelu(h, p["wi"], cfg)
    return x + _out_dense(h, p["wo"], cfg.model_axis)


def _wi_gelu(h, wi, cfg: ESM2Config):
    """wi and the gelu. Under PCT_FFN_PALLAS=1 a compute-dtype wi (never the
    int8 tree) runs as the fused K6 in ``cfg.gelu``'s mode, so the gate
    changes speed only: on the card K6 in bf16 (``csrc/ffn_gelu.cu``) or in
    f32 (K6-f32, ``csrc/ffn_gelu_f32.cu``), by the compute dtype. On the card
    every shape goes to K6, whose wrapper raises on one it does not take; a
    CPU tensor of a shape the kernel does not take gets the product then the
    gelu, as without the gate."""
    if ffn.enabled() and "w" in wi:
        B, T, H = h.shape
        M = wi["w"].shape[1]
        if h.is_cuda or ffn.fits(B * T, H, M):
            out = ffn.dense_gelu(h.reshape(B * T, H), wi["w"], wi["b"], cfg.gelu)
            return out.view(B, T, M)
    return _gelu(_dense(h, wi), cfg.gelu)


def embed(params: Params, input_ids, attention_mask, cfg: ESM2Config,
          segment_ids: torch.Tensor | None = None):
    """Token embedding with ESM-2's token-dropout rescale: <mask> rows are
    zeroed and the rest divided by (1 - observed mask ratio) over the
    sequence's TRUE length (transformers-4.32 / original-ESM semantics).
    With ``segment_ids`` (packed rows) the ratio is each segment's, so a
    packed sequence sees the ratio it has alone."""
    x = params["embed"]["word"][input_ids.long()].to(cfg.compute_dtype)
    if cfg.token_dropout:
        is_mask = input_ids == cfg.mask_token_id
        x = torch.where(is_mask[..., None], torch.zeros((), dtype=x.dtype, device=x.device), x)
        mask_ratio_train = 0.15 * 0.8
        if segment_ids is None:
            src_len = attention_mask.sum(-1).clamp(min=1).float()
            ratio_obs = is_mask.sum(-1).float() / src_len
            scale = ((1.0 - mask_ratio_train) / (1.0 - ratio_obs))[:, None]
        else:
            # per-segment counts, gathered back to tokens: a segment holds at
            # least <cls> and <eos>, so ids stay below T // 2 + 2 (slot 0 takes
            # the pads). The sums are of 0/1 values, exact in any order.
            seg = segment_ids.long()
            valid = (seg > 0).float()
            slots = torch.zeros(seg.shape[0], seg.shape[1] // 2 + 2, device=seg.device)
            cnt = slots.scatter_add(1, seg, valid)
            msk = slots.scatter_add(1, seg, is_mask.float() * valid)
            ratio_tok = torch.gather(msk / cnt.clamp(min=1.0), 1, seg)
            scale = (1.0 - mask_ratio_train) / (1.0 - ratio_tok)      # (B, T)
        x = x * scale[..., None].to(x.dtype)
    return x * attention_mask[..., None].to(x.dtype)


def _layer_block(x, lp, mask_bias, segments, cos, sin, cfg: ESM2Config):
    x = _attention_block(x, lp["attn"], mask_bias, segments, cos, sin, cfg)
    return _ffn_block(x, lp["ffn"], cfg)


def _check_shards(params: Params, cfg: ESM2Config) -> None:
    """q's width is the hidden size over the model axis: a rank's slices
    need the axis the partial products are summed over, and the axis needs
    slices."""
    width = _out_width(params["layers"]["attn"]["q"])
    parts = 1 if cfg.model_axis is None else cfg.model_axis.size
    if width * parts != cfg.hidden_size:
        raise ValueError(f"q is {width} wide, the hidden size {cfg.hidden_size} over a 'model' "
                         f"axis of {parts}: the weights and the config's model_axis disagree "
                         "(parallel/sharding.shard_params cuts the slices of "
                         "parallel.mesh.Mesh.model_axis)")


def forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            cfg: ESM2Config, remat: bool = False, segment_ids: torch.Tensor | None = None,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """last_hidden_state (B, T, H) of (B, T) token ids and 0/1 mask. With
    ``segment_ids`` and ``positions`` (packed rows, ``train/packed_engine``)
    attention is block-diagonal per segment, RoPE restarts at each segment
    and the token-dropout ratio is each segment's, so every packed sequence
    computes what it would alone. With ``remat`` and autograd recording,
    each layer runs under ``torch.utils.checkpoint`` (the TPU package's
    ``jax.checkpoint`` of the layer): the backward recomputes the layer from
    its input, so a layer keeps only that input alive."""
    B, T = input_ids.shape
    _check_shards(params, cfg)
    x = embed(params, input_ids, attention_mask, cfg, segment_ids=segment_ids)
    if _uses_kernel(x, cfg):
        attention.check_config(cfg.compute_dtype, cfg.head_dim)
        mask_bias = None
    elif segment_ids is not None:
        # query and key: a gap query row is fully masked, as K1 treats it
        allowed = ((segment_ids[:, :, None] == segment_ids[:, None, :])
                   & (segment_ids > 0)[:, None, :])
        mask_bias = torch.where(allowed[:, None], 0.0, torch.finfo(torch.float32).min)
    else:
        neg = torch.finfo(torch.float32).min
        mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * neg
    cos, sin = _rope_tables(T, cfg.head_dim, cfg.compute_dtype, x.device)
    if positions is not None:
        cos, sin = cos[positions.long()], sin[positions.long()]      # (B, T, dh)
    # a 0/1 mask is the one-segment case of segment ids
    segments = (attention_mask if segment_ids is None else segment_ids).to(torch.int32).contiguous()
    checkpoint = remat and torch.is_grad_enabled()
    for lp in _layers(params["layers"], cfg.num_layers):
        if checkpoint:
            # the layers draw no random numbers: no RNG state to replay
            x = torch.utils.checkpoint.checkpoint(
                _layer_block, x, lp, mask_bias, segments, cos, sin, cfg,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_block(x, lp, mask_bias, segments, cos, sin, cfg)
    return _layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                       cfg.layer_norm_eps)


def lm_logits(params: Params, lm_head: Params, hidden: torch.Tensor,
              cfg: ESM2Config) -> torch.Tensor:
    """ESM's MLM head over last_hidden_state, f32 (B, T, V) logits: the
    dense layer (an f32 product of hidden in its own dtype, rounded to that
    dtype, plus the f32 bias), gelu, LayerNorm, then the decoder tied to the
    token embedding, in f32, plus its bias. The 33-wide vocabulary product
    is a plain matmul, as in the TPU package (no Pallas kernel there)."""
    h = (hidden.float() @ lm_head["dense"]["w"].float()).to(hidden.dtype) + lm_head["dense"]["b"]
    h = _gelu(h, cfg.gelu)
    h = _layer_norm(h, lm_head["ln"]["w"], lm_head["ln"]["b"], cfg.layer_norm_eps)
    logits = h.float() @ params["embed"]["word"].float().T
    return logits + lm_head["bias"].float()
