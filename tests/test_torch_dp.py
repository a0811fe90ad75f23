"""The port's data-parallel CLIP training (``protein_clip_tpu_torch/parallel``)
against the JAX package's ``shard_map`` steps, on the CPU.

The port's steps run in one spawned world of two gloo ranks
(``tests/torch_dp_cases.py``, which imports no JAX), JAX's over 2 of
conftest's 8 virtual CPU devices (``tests/torch_dp_parity.py``); inputs come from
a numpy seed, the tiny backbone in f32, dropout 0, and params cross over as
numpy. Every mode of the CLIP mesh: frozen, finetune and LoRA, each one pad
bucket and packed.

Per case: the loss within 1e-5 of JAX's, and the params after one SGD step
(lr 5e-2: an update scaled by the rank count shows there, Adam hides it)
and, from the same start, after one Adam step (lr 1e-3) within 1e-5 of
JAX's (or within the bound Adam puts on an entry whose gradient is near
0); the same against the port's single-device step at the same global
batch; both ranks' params equal to the bit; the sharded eval equal to the
single-device eval within 1e-5. The packed sharded wire equals JAX's to
the bit. ``cli.main_2protein --dp 2``, from spawned ranks and from two
processes joined through ``--coordinator``, trains as JAX's ``--dp 2``
does on the same fixture and weights (losses within 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import main_2protein as jmain
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.parallel import finetune_step as jft_step
from protein_clip_tpu.parallel import packed_step as jpacked_step
from protein_clip_tpu.parallel import step as jstep
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu_torch.cli import main_2protein
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.parallel import engine, mesh, packed_step
from protein_clip_tpu_torch.train import clip_engine
from protein_clip_tpu_torch.utils import prng
from tests import torch_dp_parity as dp
from tests import torch_dp_cases as cases_mod

CFG = dict(batch_size=4, accumulated_batches=2, num_chunks=4)
MODES = [("frozen", False), ("frozen", True), ("finetune", False), ("finetune", True),
         ("lora", False), ("lora", True)]
NAMES = [f"{m}-{'packed' if p else 'padded'}" for m, p in MODES]


def _jmcfg():
    esm_cfg = jesm2.ESM2Config.tiny()
    return jclip.CLIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=16, dropout=0.0,
                            esm=esm_cfg)


@pytest.fixture(scope="module")
def cases():
    """name -> case (``torch_dp_cases``' form): the tiny backbone and heads
    from JAX's init, noisy LoRA adapters, a global batch of 8 pairs."""
    jmcfg = _jmcfg()
    jesm = dp.np_tree(jesm2.init_params(jax.random.key(1), jmcfg.esm))
    jheads = dp.np_tree(jclip.init_params(jax.random.key(2), jmcfg))
    rng = np.random.default_rng(21)
    peps, recs = dp.seqs(rng, 8, 5, 15), dp.seqs(rng, 8, 10, 40)
    adapters = dp.noisy_adapters(jlora.init_lora(jax.random.key(3), jesm, 2), rng)
    trees = {"frozen": (jheads, jesm),
             "finetune": (dp.np_tree(jfinetune.init_params(jesm, jheads)), {}),
             "lora": ({"lora": adapters, "heads": jheads}, jesm)}
    return {name: dict(arch="clip", mode=mode, packed=packed, cfg=CFG, params=trees[mode][0],
                       esm=trees[mode][1], peps=peps, recs=recs)
            for name, (mode, packed) in zip(NAMES, MODES)}


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    future, pool = dp.world_future(cases, tmp_path_factory.mktemp("dp_world"))
    yield future
    pool.shutdown()


def jax_step(case: dict) -> list:
    jcfg = jengine.EngineConfig(model=_jmcfg(), remat=False, **case["cfg"])
    tx, m = dp.capture(), dp.jax_mesh()
    if case["packed"]:
        factory = {"frozen": jpacked_step.make_sharded_packed_train_step,
                   "finetune": jft_step.make_sharded_packed_finetune_step,
                   "lora": jft_step.make_sharded_packed_lora_step}[case["mode"]]
        batch = jpacked_step.tokenize_packed_sharded(JaxTokenizer(), case["peps"], case["recs"],
                                                     2)
    else:
        factory = {"frozen": jstep.make_sharded_train_step,
                   "finetune": jft_step.make_sharded_finetune_step,
                   "lora": jft_step.make_sharded_lora_step}[case["mode"]]
        batch = jstep.shard_batch(m, jengine.tokenize_pair_batch(JaxTokenizer(), case["peps"],
                                                                 case["recs"]))
    return dp.run_jax(dp.build(factory, jcfg, tx, m), tx, case, batch)


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_matches_jax_and_one_device(cases, world, name):
    jax_out = jax_step(cases[name])
    dp.check_case(cases[name], [r[name] for r in world.result()], jax_out)


def test_pmean_grads_buckets_average_every_gradient(world):
    """On the two ranks, pmean_grads in buckets of 64 bytes (leaves of two
    dtypes, gradients in place and in buckets, one not contiguous, one
    leaf with none) leaves every gradient the mean of the ranks', (g + 2g)
    / 2 of the draw g, on both ranks alike."""
    ranks = [r["pmean"] for r in world.result()]
    for i, draw in enumerate(cases_mod.pmean_draws()):
        if draw is None:
            assert ranks[0][i] is None and ranks[1][i] is None
            continue
        want = ((draw + draw * 2) / 2).numpy()
        for got in ranks:
            assert got[i].dtype == want.dtype
            np.testing.assert_array_equal(got[i], want, err_msg=f"leaf {i}")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_packed_sharded_wire_equals_jax(n_shards):
    """``tokenize_packed_sharded`` and ``_deal_pairs`` give JAX's arrays to
    the bit: skewed lengths (a shard packs fewer rows and pads with
    all-<pad> ones), rows past 128 tokens, explicit row widths; a rank's
    shard is its rows and its operm."""
    rng = np.random.default_rng(n_shards)
    for peps, recs, widths in (
            (dp.seqs(rng, 16, 5, 15), dp.seqs(rng, 16, 10, 60), {}),
            (dp.seqs(rng, 16, 5, 30), dp.seqs(rng, 8, 5, 20) + dp.seqs(rng, 8, 150, 300), {}),
            (dp.seqs(rng, 8, 5, 15), dp.seqs(rng, 8, 10, 60),
             dict(pep_row_len=32, rec_row_len=64))):
        got = packed_step.tokenize_packed_sharded(EsmTokenizer(), peps, recs, n_shards, **widths)
        want = jpacked_step.tokenize_packed_sharded(JaxTokenizer(), peps, recs, n_shards,
                                                    **widths)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        lens = ([len(p) for p in peps], [len(r) for r in recs])
        assert (packed_step._deal_pairs(*lens, n_shards)
                == jpacked_step._deal_pairs(*lens, n_shards))
        shard = packed_step.shard_of(got, n_shards - 1)
        rows = got["rec_ids"].shape[0] // n_shards
        assert torch.equal(shard["rec_ids"], got["rec_ids"][-rows:])
        assert torch.equal(shard["pep_operm"], got["pep_operm"][-1])


def test_mesh_guards():
    """Outside a process group the mesh is one rank, and a 'model' axis
    needs its ranks too (tests/test_torch_tp.py runs it); pipeline stages
    are not ported; a shard dealt for another data axis, or a batch of
    another wire, is refused before it misroutes tokens."""
    assert mesh.make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.make_mesh(data=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        engine.MeshEngine(model=2)
    with pytest.raises(NotImplementedError, match="multi-device"):
        engine.MeshEngine(stages=2)
    rng = np.random.default_rng(0)
    peps, recs = dp.seqs(rng, 8, 5, 15), dp.seqs(rng, 8, 10, 40)
    mcfg = clip.CLIPConfig(input_dim=64, embedding_dim=16, esm=esm2.ESM2Config.tiny())
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=8, accumulated_batches=1, packed=True)
    step = engine.MeshEngine(packed=True).make_train_step(cfg)
    four = packed_step.shard_of(
        packed_step.tokenize_packed_sharded(EsmTokenizer(), peps, recs, 4), 0)
    with pytest.raises(ValueError, match="n_shards must equal the data axis"):
        step(None, None, None, four, None)
    with pytest.raises(ValueError, match="one shard of tokenize_packed_sharded"):
        step(None, None, None, clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs), None)
    prepare = engine.MeshEngine(packed=True).make_prepare(cfg, EsmTokenizer())
    assert prepare(peps, recs)["pep_operm"].shape == (8,)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli.main_2protein --dp 2``: JAX's (in this process, its heads'
    init patched to the heads the port's CLI draws from --seed), the
    port's from spawned ranks and from two --coordinator processes."""
    d = tmp_path_factory.mktemp("dp_cli")
    argv, esm_cfg = dp.cli_fixture(d)
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, dropout=0.0, esm=esm_cfg)
    heads = cases_mod.to_numpy(clip.init_params(mcfg, prng.set_seed(42), device="cpu"))
    argv += ["--epochs", "1", "--batch-size", "4", "--accumulated-batches", "2",
             "--num-chunks", "2", "--length-groups", "1", "--dp", "2"]
    return dp.run_clis(d, jmain.main, main_2protein.main,
                       "protein_clip_tpu_torch.cli.main_2protein", argv,
                       {(jclip, "init_params"): lambda key, cfg: jax.tree.map(jax.numpy.asarray,
                                                                              heads)},
                       coordinator=True)


@pytest.mark.parametrize("launch", ["spawned", "coordinator"])
def test_cli_dp2_matches_jax(cli_runs, launch):
    dp.assert_metrics_close(cli_runs[launch], cli_runs["jax"])
