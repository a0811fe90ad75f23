"""ESM-2 encoder in PyTorch: the port of ``protein_clip_tpu/models/esm2.py``.

Parameters are a nested dict of tensors in the TPU package's layout (layers
stacked on a leading layer axis, linear weights ``(in, out)``), so
``train/checkpoint.from_numpy_tree`` carries that package's weights over as
they are. The precision contract is the same: bf16 (or f32) operands with
f32 accumulation in the matmuls, LayerNorm and softmax in f32, q scaled by
dh^-0.5 before RoPE, ESM's exact-erf GELU by default, and token dropout
rescaled by the observed mask ratio over each sequence's true length.

Attention: with ``attention_impl="fused"`` on CUDA tensors each layer calls
the hand-written kernels (``ops/attention.fused_attention``: K1 forward, K5
backward), for every sequence length; the kernels take bf16 at head_dim 32,
and ``forward`` raises on CUDA for any other config unless it asks for
``attention_impl="eager"``. Otherwise the eager form runs: f32 scores plus an
additive f32-min key mask, f32 softmax, probabilities cast to the compute
dtype, P.V in f32. The two differ only at pad query rows (the kernel's are
a uniform average, the eager ones attend to the valid keys), which pooling
drops.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import attention
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
    # "fused": the CUDA kernel K1 on CUDA tensors, which takes bf16 at
    # head_dim 32 and raises on anything else; "eager": einsum + masked
    # softmax, the plain version, on any device.
    attention_impl: str = "fused"
    # FFN gelu: "erf" (ESM's exact form, the parity contract) or "tanh".
    gelu: str = "erf"

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
    # x: (B, T, heads, dh); cos/sin: (T, dh)
    return x * cos[None, :, None, :] + _rotate_half(x) * sin[None, :, None, :]


def _dense(x, lp):
    """(B, T, in) @ (in, out) + b: bf16 or f32 operands, f32 accumulation,
    result in the operands' dtype, then the bias."""
    return torch.matmul(x, lp["w"]) + lp["b"]


def _attention_block(x, p, mask_bias, segments, cos, sin, cfg: ESM2Config):
    """Pre-LN attention residual block in the (B, T, heads, dh) layout.
    ``segments`` is the (B, T) int32 0/1 mask; ``mask_bias`` its additive
    f32 form for the eager path."""
    B, T, H = x.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    h = _layer_norm(x, p["ln"]["w"], p["ln"]["b"], cfg.layer_norm_eps)
    q = _dense(h, p["q"]).view(B, T, nh, dh) * (dh ** -0.5)  # ESM scales q before RoPE
    k = _dense(h, p["k"]).view(B, T, nh, dh)
    v = _dense(h, p["v"]).view(B, T, nh, dh)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)

    if cfg.attention_impl == "fused" and x.is_cuda:
        ctx = attention.fused_attention(q, k, v, segments)
    else:
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) + mask_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(x.dtype)
    return x + _dense(ctx.reshape(B, T, H), p["o"])


def _ffn_block(x, p, cfg: ESM2Config):
    h = _layer_norm(x, p["ln"]["w"], p["ln"]["b"], cfg.layer_norm_eps)
    h = _gelu(_dense(h, p["wi"]), cfg.gelu)
    return x + _dense(h, p["wo"])


def embed(params: Params, input_ids, attention_mask, cfg: ESM2Config):
    """Token embedding with ESM-2's token-dropout rescale: <mask> rows are
    zeroed and the rest divided by (1 - observed mask ratio) over the
    sequence's TRUE length (transformers-4.32 / original-ESM semantics)."""
    x = params["embed"]["word"][input_ids.long()].to(cfg.compute_dtype)
    if cfg.token_dropout:
        is_mask = input_ids == cfg.mask_token_id
        x = torch.where(is_mask[..., None], torch.zeros((), dtype=x.dtype, device=x.device), x)
        mask_ratio_train = 0.15 * 0.8
        src_len = attention_mask.sum(-1).clamp(min=1).float()
        ratio_obs = is_mask.sum(-1).float() / src_len
        scale = ((1.0 - mask_ratio_train) / (1.0 - ratio_obs))[:, None]
        x = x * scale[..., None].to(x.dtype)
    return x * attention_mask[..., None].to(x.dtype)


def _layer_block(x, lp, mask_bias, segments, cos, sin, cfg: ESM2Config):
    x = _attention_block(x, lp["attn"], mask_bias, segments, cos, sin, cfg)
    return _ffn_block(x, lp["ffn"], cfg)


def forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            cfg: ESM2Config, remat: bool = False) -> torch.Tensor:
    """last_hidden_state (B, T, H) of (B, T) token ids and 0/1 mask. With
    ``remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` (the TPU package's ``jax.checkpoint`` of the
    layer): the backward recomputes the layer from its input, so a layer
    keeps only that input alive."""
    B, T = input_ids.shape
    x = embed(params, input_ids, attention_mask, cfg)
    if cfg.attention_impl == "fused" and x.is_cuda:
        attention.check_config(cfg.compute_dtype, cfg.head_dim)
    neg = torch.finfo(torch.float32).min
    mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * neg
    cos, sin = _rope_tables(T, cfg.head_dim, cfg.compute_dtype, x.device)
    segments = attention_mask.to(torch.int32).contiguous()
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
