"""The port's data-parallel FILIP training (``parallel/filip_step.py``,
``packed_step.py``, ``filip_finetune_step.py``) against the JAX package's
``shard_map`` steps, on the CPU, as ``test_torch_dp.py`` holds CLIP's: one
spawned world of two gloo ranks for every case, JAX over 2 of the 8
virtual devices, the tiny backbone in f32, dropout 0.

Cases: frozen one bucket and packed, frozen with DCL, finetune and LoRA
each one bucket and packed. Each rank scores its peptides against the
gathered receptor tokens; per case the loss within 1e-5 of JAX's and of the
port's single-device step at the same batch, the params after one SGD and
one Adam step within 1e-5 (Adam: or the bound it puts on an entry whose
gradient is near 0), both ranks equal to the bit, the sharded eval within
1e-5 of the single-device eval. Also the row loss's diagonal at every
rank's offset, and ``cli.main_2protein_filip --dp 2 --packed --lora-rank
2`` against JAX's on the same fixture and weights.
"""

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import main_2protein_filip as jmain
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.parallel import filip_finetune_step as jffs
from protein_clip_tpu.parallel import filip_step as jfilip_step
from protein_clip_tpu.parallel import packed_step as jpacked_step
from protein_clip_tpu.parallel import step as jstep
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu_torch.cli import main_2protein_filip
from protein_clip_tpu_torch.models import esm2, filip
from protein_clip_tpu_torch.ops.infonce import filip_loss
from protein_clip_tpu_torch.parallel import filip_step
from protein_clip_tpu_torch.train import checkpoint, lora
from protein_clip_tpu_torch.utils import prng
from tests import torch_dp_parity as dp
from tests import torch_dp_cases as cases_mod

CFG = dict(batch_size=8, accumulated_batches=1, num_chunks=4)
CASES = {"frozen-padded": ("frozen", False, False), "frozen-packed": ("frozen", True, False),
         "frozen-padded-dcl": ("frozen", False, True),
         "finetune-padded": ("finetune", False, False),
         "finetune-packed": ("finetune", True, False), "lora-padded": ("lora", False, False),
         "lora-packed": ("lora", True, False)}


def _jmcfg():
    esm_cfg = jesm2.ESM2Config.tiny()
    return jfilip.FILIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=16, dropout=0.0,
                              esm=esm_cfg)


@pytest.fixture(scope="module")
def cases():
    jmcfg = _jmcfg()
    jesm = dp.np_tree(jesm2.init_params(jax.random.key(1), jmcfg.esm))
    jheads = dp.np_tree(jfilip.init_params(jax.random.key(2), jmcfg))
    rng = np.random.default_rng(22)
    peps, recs = dp.seqs(rng, 8, 5, 15), dp.seqs(rng, 8, 10, 40)
    adapters = dp.noisy_adapters(jlora.init_lora(jax.random.key(3), jesm, 2), rng)
    trees = {"frozen": (jheads, jesm),
             "finetune": (dp.np_tree(jfinetune.init_params(jesm, jheads)), {}),
             "lora": ({"lora": adapters, "heads": jheads}, jesm)}
    return {name: dict(arch="filip", mode=mode, packed=packed, use_dcl=dcl, cfg=CFG,
                       params=trees[mode][0], esm=trees[mode][1], peps=peps, recs=recs)
            for name, (mode, packed, dcl) in CASES.items()}


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    future, pool = dp.world_future(cases, tmp_path_factory.mktemp("dp_filip_world"))
    yield future
    pool.shutdown()


def jax_step(case: dict) -> list:
    jcfg = jengine.EngineConfig(model=_jmcfg(), remat=False, filip_use_dcl=case["use_dcl"],
                                **case["cfg"])
    tx, m = dp.capture(), dp.jax_mesh()
    if case["mode"] != "frozen":
        step = dp.build(jffs.make_sharded_filip_finetune_step, jcfg, tx, m,
                        packed=case["packed"], lora=case["mode"] == "lora")
    elif case["packed"]:
        step = dp.build(jpacked_step.make_sharded_packed_filip_step, jcfg, tx, m)
    else:
        step = jfilip_step.make_sharded_filip_train_step(jcfg, tx, m)
    if case["packed"]:
        batch = jpacked_step.tokenize_packed_sharded(JaxTokenizer(), case["peps"], case["recs"],
                                                     2)
    else:
        batch = jstep.shard_batch(m, jengine.tokenize_pair_batch(JaxTokenizer(), case["peps"],
                                                                 case["recs"]))
    return dp.run_jax(step, tx, case, batch)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_filip_step_matches_jax_and_one_device(cases, world, name):
    jax_out = jax_step(cases[name])
    dp.check_case(cases[name], [r[name] for r in world.result()], jax_out)


@pytest.mark.parametrize("use_dcl", [False, True])
def test_row_loss_is_filip_loss_over_the_ranks_rows(use_dcl):
    """Outside a process group ``row_loss`` of the whole (B, B) scores is
    ``filip_loss``; the positives of the rank at index r sit at columns r *
    b_local + i (``local_diagonals``), and the row sums of the ranks' row
    blocks add up to B times the direction's loss."""
    sim_a, sim_b = (torch.randn(8, 8, generator=torch.Generator().manual_seed(s))
                    for s in (1, 2))
    np.testing.assert_allclose(float(filip_step.row_loss(sim_a, sim_b, 0, use_dcl)),
                               float(filip_loss(sim_a, sim_b, use_dcl)), rtol=1e-6)
    rows = sim_a.reshape(2, 4, 8)
    for r in range(2):
        assert torch.equal(filip_step.local_diagonals(rows[r], 4, 8, r),
                           torch.diagonal(sim_a)[4 * r:4 * r + 4])
    total = sum(filip_step._row_direction_loss_sum(
        rows[r], filip_step.local_diagonals(rows[r], 4, 8, r), r, use_dcl) for r in range(2))
    np.testing.assert_allclose(float(total) / 8, float(filip_loss(sim_a, sim_a, use_dcl)),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli.main_2protein_filip --dp 2 --packed --lora-rank 2``: JAX's (its
    heads' and adapters' inits patched to the port CLI's draws from --seed)
    and the port's from spawned ranks."""
    d = tmp_path_factory.mktemp("dp_filip_cli")
    argv, esm_cfg = dp.cli_fixture(d)
    mcfg = filip.FILIPConfig(input_dim=esm_cfg.hidden_size, dropout=0.0, esm=esm_cfg)
    heads = cases_mod.to_numpy(filip.init_params(mcfg, prng.set_seed(42), device="cpu"))
    esm = checkpoint.load_npz(d / "esm.npz", esm2.abstract_params(esm_cfg, torch.float32), "cpu")
    adapters = cases_mod.to_numpy(lora.init_lora(torch.Generator().manual_seed(43), esm, 2))
    argv += ["--epochs", "1", "--batch-size", "4", "--num-chunks", "1", "--dp", "2",
             "--packed", "--lora-rank", "2"]
    as_jax = lambda tree: (lambda *a, **k: jax.tree.map(jax.numpy.asarray, tree))  # noqa: E731
    return dp.run_clis(d, jmain.main, main_2protein_filip.main,
                       "protein_clip_tpu_torch.cli.main_2protein_filip", argv,
                       {(jfilip, "init_params"): as_jax(heads),
                        (jlora, "init_lora"): as_jax(adapters)})


def test_cli_dp2_packed_lora_matches_jax(cli_runs):
    dp.assert_metrics_close(cli_runs["spawned"], cli_runs["jax"])
