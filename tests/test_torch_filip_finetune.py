"""The port's unfrozen FILIP training (``train/filip_finetune.py``, the
token-level two-pass step, one bucket or packed; ``train/filip_lora.py``)
against the JAX package's, on the CPU in float32: tiny ESM config, 32-d
token heads, inputs made from a numpy seed, parameters carried across as
numpy, JAX's side through its fused similarity in interpret mode.

- The two passes against the port's own monolithic loss (one graph over
  the same chunks and dropout seeds, dropout 0.5): loss within 1e-6
  relative, every gradient within 1e-6 of its leaf's largest entry; pass 2
  must redraw pass 1's masks for that to hold.
- The two-pass gradients at dropout 0 against ``jax.grad`` of JAX's
  ``make_token_loss`` / ``make_packed_token_loss`` (the same math as its
  steps' two passes), full finetune and LoRA, one bucket and packed at 4
  scatter tiers: within 1e-5 of each leaf's largest entry (gradients, not
  Adam's first update; ROADMAP lessons). The eval steps within 1e-5.
- ``cli.main_2protein_filip --finetune`` and ``--lora-rank`` on the CPU,
  plain and ``--packed``; the checkpoints through JAX's loader score as
  the port's.

Short pairs keep the max-sim's maxima away from ties (see
``test_torch_filip_packed.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.ops import filip_pallas as jops
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import filip_finetune as jfft
from protein_clip_tpu.train import filip_lora as jflora
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu.train import packed_engine as jpacked
from protein_clip_tpu_torch.cli import common, main_2protein_filip as cli
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import esm2, filip
from protein_clip_tpu_torch.ops import filip as filip_ops
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_finetune, filip_lora,
                                          lora, optimizer, packed_engine)

PASS_TOL = 1e-6
ATOL = RTOL = 1e-5
D = 32
N = 8
RANK = 4
AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]
ENGINES = {"finetune": filip_finetune, "lora": filip_lora}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small and
    many, and under the suite's parallel workers a full thread pool a
    worker oversubscribes the CPU, whose spin-waits then cost more than the
    ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(seed):
    """N pairs, mostly short, one long receptor (rows of 128 and 256: two
    receptor tiers)."""
    rng = np.random.default_rng(seed)
    rec = [int(k) for k in rng.integers(20, 60, N - 1)] + [200]
    return (["".join(rng.choice(AAS, int(k))) for k in rng.integers(5, 25, N)],
            ["".join(rng.choice(AAS, k)) for k in rec])


def _batches(seed, packed):
    """The same pairs tokenized by each package: (JAX batch, port batch)."""
    peps, recs = _pairs(seed)
    if packed:
        return (jpacked.tokenize_packed(JaxTokenizer(), peps, recs, scatter_tiers=4),
                packed_engine.tokenize_packed(EsmTokenizer(), peps, recs, scatter_tiers=4))
    return (jengine.tokenize_pair_batch(JaxTokenizer(), peps, recs),
            clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs))


def _cfgs(dropout=0.0, **kw):
    """(JAX, port) engine configs over the tiny backbone: N pairs, 2 chunks
    (packed: 4 rows a chunk, so each side takes several)."""
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=dropout,
                               esm=jesm2.ESM2Config.tiny())
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=dropout,
                             esm=esm2.ESM2Config.tiny())
    kw = dict(batch_size=N, accumulated_batches=1, num_chunks=2, scatter_tiers=4, **kw)
    return jengine.EngineConfig(model=jmcfg, **kw), clip_engine.EngineConfig(model=mcfg, **kw)


@pytest.fixture(scope="module")
def tiny():
    """{mode: (JAX params, JAX esm_params)} and the port's base: the
    finetune tree, and the LoRA tree with B moved off zero by random
    entries (a constant B gives A no generic gradient: ROADMAP lessons)."""
    jmcfg = _cfgs()[0].model
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    jheads = jfilip.init_params(jax.random.key(2), jmcfg)
    zero = jlora.init_lora(jax.random.key(3), jesm, RANK)
    adapters = {name: {"a": ab["a"],
                       "b": 0.01 * jax.random.normal(jax.random.key(i), ab["b"].shape)}
                for i, (name, ab) in enumerate(zero.items())}
    return {"finetune": (jfft.init_params(jesm, jheads), {}),
            "lora": (jlora.init_params(adapters, jheads), jesm)}


def _port(jparams, jesm):
    """The port's (params, esm_params) of a JAX pair."""
    return (checkpoint.from_numpy_tree(_np(jparams), "cpu"),
            checkpoint.from_numpy_tree(_np(jesm), "cpu") if jesm else {})


class _Capturing:
    """Every group at lr 0, keeping the gradients the step applies (zeros
    for a leaf that takes none: FILIP reads no ``emb_ffn``)."""

    def __init__(self, params):
        self.flat = checkpoint._flatten(params)
        self.state = optimizer.multi_transform({k: optimizer.adam(0.0) for k in params}).init(
            params)
        self.grads = None

    def apply(self):
        self.grads = {k: torch.zeros_like(t) if t.grad is None else t.grad.detach().clone()
                      for k, t in self.flat.items()}
        self.state.apply()


def _view(mode, cfg):
    return (lora if mode == "lora" else filip_finetune).esm_view(cfg)


def _two_pass(mode, cfg, jparams, jesm, batch, seed):
    """One two-pass step of ``mode`` from the JAX pair's weights: (loss,
    gradients by leaf). One bucket through the engine's make_train_step;
    packed at 4 rows a chunk, so each side takes several chunks."""
    params, esm = _port(jparams, jesm)
    state = _Capturing(params)
    step = (filip_finetune.make_train_step_packed(cfg, rows_per_chunk=4, view=_view(mode, cfg))
            if cfg.packed else ENGINES[mode].make_train_step(cfg))
    _, _, loss = step(params, state, esm, batch,
                      None if seed is None else torch.Generator().manual_seed(seed))
    return float(loss), state.grads


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("mode", list(ENGINES))
def test_two_passes_equal_the_monolithic_loss_with_dropout(tiny, mode, packed):
    _, cfg = _cfgs(dropout=0.5, packed=packed)
    jparams, jesm = tiny[mode]
    batch = _batches(11, packed)[1]
    loss, grads = _two_pass(mode, cfg, jparams, jesm, batch, 7)
    params, esm = _port(jparams, jesm)
    flat = checkpoint._flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    mono = (filip_finetune.make_packed_token_loss(cfg, rows_per_chunk=4, view=_view(mode, cfg))
            if packed else filip_finetune.make_token_loss(cfg, view=_view(mode, cfg)))(
        params, esm, batch, torch.Generator().manual_seed(7))
    mono.backward()
    np.testing.assert_allclose(loss, float(mono.detach()), rtol=PASS_TOL)
    for k, t in flat.items():
        want = torch.zeros_like(t) if t.grad is None else t.grad
        err = float((grads[k] - want).abs().max())
        assert err <= PASS_TOL * float(want.abs().max()), (k, err)
    other = _two_pass(mode, cfg, jparams, jesm, batch, 8)[1]
    assert any(not torch.allclose(grads[k], other[k]) for k in grads)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("mode", list(ENGINES))
def test_gradients_match_jax(tiny, mode, packed):
    jcfg, cfg = _cfgs(packed=packed)
    jparams, jesm = tiny[mode]
    jb, b = _batches(12, packed)
    view = {} if mode == "finetune" else {"esm_view": jflora._esm_view(None)}
    jloss_fn = (jfft.make_packed_token_loss(jcfg, jops.filip_similarity_fused,
                                            rows_per_chunk=4, **view) if packed
                else jfft.make_token_loss(jcfg, jops.filip_similarity_fused, **view))
    loss, grads = _two_pass(mode, cfg, jparams, jesm, b, None)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams, jesm, jb, jax.random.key(0))
    np.testing.assert_allclose(loss, float(jloss), rtol=RTOL)
    jg = checkpoint._flatten(_np(jgrads))
    assert grads.keys() == jg.keys()
    backbone = "lora/" if mode == "lora" else "esm/"
    assert max(float(np.abs(v).max()) for k, v in jg.items() if k.startswith(backbone)) > 1e-6
    for k, want in jg.items():
        err = float(np.abs(grads[k].numpy() - want).max())
        assert err <= ATOL * float(np.abs(want).max()), (k, err)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_eval_steps_match_jax(tiny, packed):
    """The finetune eval on its cast backbone, the LoRA eval on the merge."""
    jcfg, cfg = _cfgs(packed=packed, filip_use_dcl=True)
    jb, b = _batches(13, packed)
    for mode, jengine_mod in (("finetune", jfft), ("lora", jflora)):
        jparams, jesm = tiny[mode]
        want = jengine_mod.make_eval_step(jcfg, jops.filip_similarity_fused)(jparams, jesm, jb)
        got = ENGINES[mode].make_eval_step(cfg)(*_port(jparams, jesm), b)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, err_msg=mode)


def test_grouped_and_width_tiered_batches_are_refused(tiny):
    _, cfg = _cfgs(length_groups=2)
    with pytest.raises(ValueError, match="grouped FILIP finetune is not wired"):
        filip_finetune.make_train_step(cfg)
    _, cfg = _cfgs(packed=True)
    with pytest.raises(ValueError, match="flat packing only.*width-tiered finetune is not wired"):
        filip_lora.make_train_step(_cfgs(packed=True, packed_tiers=2)[1])
    params, esm = _port(*tiny["finetune"])
    batch = packed_engine.tokenize_packed(EsmTokenizer(), *_pairs(14), tier_widths=[128, 256])
    assert "rec_packs" in batch
    with pytest.raises(ValueError, match="flat packing only"):
        filip_finetune.make_train_step(cfg)(params, _Capturing(params), esm, batch, None)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

SMALL_RUN = ["--batch-size", "4", "--fixture-families", "30", "--embedding-dim", str(D),
             "--epochs", "1", "--num-chunks", "2"]


@pytest.mark.parametrize("mode_args", [["--finetune"], ["--finetune", "--packed"],
                                       ["--lora-rank", str(RANK)],
                                       ["--lora-rank", str(RANK), "--packed"]],
                         ids=["finetune", "finetune_packed", "lora", "lora_packed"])
def test_cli_unfrozen_runs_and_its_checkpoint_loads_in_jax(tmp_path, mode_args):
    """The run contract with finite losses; best_model.npz holds {heads,
    esm} or {heads, lora}; JAX's load_clip_checkpoint (given the CLI's
    random base) and the port's give the same backbone, leaf by leaf within
    1e-5 (LoRA's merge included), and heads whose FILIP scores of the same
    hidden states agree within 1e-5 (the backbone forwards are held against
    JAX's in the port's ESM-2 tests)."""
    assert cli.main(TINY + SMALL_RUN + mode_args + [
        "--synthetic-fixture", "--data-dir", str(tmp_path / "data"), "--runs-dir",
        str(tmp_path / "runs")]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    assert sorted(p.name for p in run.iterdir()) == [
        "best_model.npz", "figures", "losses_per_epoch.txt", "metrics.jsonl", "state"]
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(","))
    part = "esm" if "--finetune" in mode_args else "lora"
    with np.load(run / "best_model.npz") as ckpt:
        assert {k.split("/")[0] for k in ckpt.files} == {"heads", part}
    esm_cfg = common.esm_config("tiny", "float32")
    base = common.load_esm(cli.build_argparser().parse_args(TINY), esm_cfg, torch.device("cpu"))
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, esm=esm_cfg)
    heads, backbone = common.load_clip_checkpoint(run / "best_model.npz", mcfg, base, "cpu")
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, esm=jesm2.ESM2Config.tiny())
    jheads, jbackbone = jcommon.load_clip_checkpoint(
        run / "best_model.npz", jmcfg, jax.tree.map(jnp.asarray, _np_torch(base)))
    got_esm = checkpoint._flatten(_np_torch(backbone))
    want_esm = checkpoint._flatten(_np(jbackbone))
    assert got_esm.keys() == want_esm.keys()
    for k, v in got_esm.items():
        np.testing.assert_allclose(v, want_esm[k], rtol=0, atol=ATOL, err_msg=k)
    rng = np.random.default_rng(9)
    hp, hr = (rng.normal(size=(5, T, 64)).astype(np.float32) for T in (12, 30))
    ma = (np.arange(12)[None] < rng.integers(2, 13, (5, 1))).astype(np.int32)
    mb = (np.arange(30)[None] < rng.integers(2, 31, (5, 1))).astype(np.int32)
    want = jops.filip_similarity_fused(
        jfilip.encode_side_tokens(jheads, "pep", jnp.asarray(hp), jmcfg),
        jfilip.encode_side_tokens(jheads, "rec", jnp.asarray(hr), jmcfg),
        jnp.asarray(ma), jnp.asarray(mb), jheads["temperature"])
    with torch.no_grad():
        got = filip_ops.filip_similarity_fused(
            filip.encode_side_tokens(heads, "pep", torch.from_numpy(hp), mcfg),
            filip.encode_side_tokens(heads, "rec", torch.from_numpy(hr), mcfg),
            torch.from_numpy(ma), torch.from_numpy(mb), heads["temperature"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _np_torch(tree):
    if isinstance(tree, dict):
        return {k: _np_torch(v) for k, v in tree.items()}
    return tree.detach().numpy()
