"""The port's MLM mesh (``parallel/mlm_step.py``, ``cli.mlm_train --dp/--tp``)
against the JAX package's ``parallel/mlm_step.py`` factories, on the CPU.

The port's steps run in one spawned world of two gloo ranks (``tests/
torch_dp_cases.py``, which imports no JAX): a (2, 1) mesh (dp = 2) and a
(1, 2) one (tp = 2: the backbone and the finetune masters in Megatron
slices). JAX's run over conftest's virtual CPU devices on the same mesh
shape, its backbone on ``sharding.esm_param_specs``' shardings under a
model axis; but its unfrozen steps on a (1, 2) mesh of virtual CPU
devices stop in XLA's SPMD partitioner ("Cross-partition allreduce must
be in (partial) manual partitioning mode"), so the port's unfrozen tp = 2
steps are held against JAX's step on a (1, 1) mesh, the same step over
the same shard and masks. Each data shard's masks are JAX's own (``mask_tokens(fold_in(
key, i), shard, ...)``), fed to the port. The tiny backbone in f32, params
crossed as numpy. Cases: the head step plain and packed (the rows dealt by
``tokenize_packed_rows_sharded``), the finetune step plain and packed, the
LoRA step plain, each at dp = 2 and at tp = 2.

Per case: the loss (the mean over every shard's masked positions) within
1e-5 of JAX's and of the port's one-device step over the joined batch and
masks; the params after one SGD and one Adam step within 1e-5 (Adam: or
its bound where a gradient is near 0); both ranks equal to the bit (split
leaves gathered); the eval step within 1e-5. Also the sharded packed wire
against JAX's to the bit, and ``cli.mlm_train --dp 2 --finetune`` and
``--tp 2`` against JAX's CLI on one fixture (at --mask-prob 1, where
both packages mask every maskable token, so their masks agree).
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import mlm_train as jmlm_train
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import mlm as jmlm
from protein_clip_tpu.parallel import mlm_step as jmlm_step
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu.train import packed_engine as jpacked
from protein_clip_tpu_torch.cli import mlm_train
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.train import packed_engine
from protein_clip_tpu_torch.utils import prng
from tests import torch_dp_cases as cases_mod
from tests import torch_dp_parity as dp

P = 0.3
RANK = 2
MODES = {"head": ("head", False), "head-packed": ("head", True),
         "finetune": ("finetune", False), "finetune-packed": ("finetune", True),
         "lora": ("lora", False)}
MESHES = {"dp2": (2, 1), "tp2": (1, 2)}
CASES = {f"{m}-{mesh}": (m, mesh) for mesh in MESHES for m in MODES}


def _shard_masks(arrs, packed: bool, data: int, key) -> list:
    """JAX's masks of each data shard, as its sharded steps draw them."""
    out = []
    n = arrs[0].shape[0] // data
    for i in range(data):
        part = [a[i * n:(i + 1) * n] for a in arrs]
        if packed:
            ids, seg, _ = jpacked.derive_segments(jnp.asarray(part[0]))
            mask = (seg > 0).astype(jnp.int32)
        else:
            ids, mask = (jnp.asarray(a) for a in part)
        masked, labels = jmlm.mask_tokens(jax.random.fold_in(key, i), ids, mask, P)
        out.append((np.asarray(masked, np.int32), np.asarray(labels, np.int32)))
    return out


@pytest.fixture(scope="module")
def cases():
    jcfg = jesm2.ESM2Config.tiny()
    jesm = dp.np_tree(jesm2.init_params(jax.random.key(0), jcfg))
    head = dp.np_tree(jesm2.init_lm_head(jax.random.key(1), jcfg))
    rng = np.random.default_rng(31)
    seqs = dp.seqs(rng, 8, 4, 20)
    adapters = dp.noisy_adapters(jlora.init_lora(jax.random.key(2), jesm, RANK), rng)
    trees = {"head": (head, jesm),
             "finetune": ({"esm": dp.np_tree(jfinetune.init_params(jesm, {})["esm"]),
                           "head": head}, {}),
             "lora": ({"lora": adapters, "head": head}, jesm)}
    out = {}
    for name, (m, mesh_name) in CASES.items():
        mode, packed = MODES[m]
        data, model = MESHES[mesh_name]
        if packed:
            arrs = (np.asarray(jpacked.tokenize_packed_rows_sharded(JaxTokenizer(), seqs, data,
                                                                    row_len=32)),)
        else:
            enc = JaxTokenizer()(seqs)
            arrs = (np.asarray(enc["input_ids"], np.int32),
                    np.asarray(enc["attention_mask"], np.int32))
        out[name] = dict(arch="mlm", mode=mode, packed=packed, tp=model, data=data,
                         params=trees[mode][0], esm=trees[mode][1], arrs=arrs,
                         masks=_shard_masks(arrs, packed, data, jax.random.key(0)))
    return out


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    future, pool = dp.world_future({**cases, "__extras__": {}},
                                   tmp_path_factory.mktemp("mlm_world"))
    yield future
    pool.shutdown()


def jax_step(case: dict) -> list:
    cfg = jesm2.ESM2Config.tiny()
    # JAX's unfrozen steps on a (1, 2) mesh stop in XLA's SPMD partitioner:
    # their model axis is held on a (1, 1) mesh (the same step)
    model = case["tp"] if case["mode"] == "head" else 1
    m = dp.jax_mesh(case["data"], model)
    tx = dp.capture()
    if case["mode"] == "head":
        factory = (jmlm_step.make_sharded_packed_mlm_train_step if case["packed"]
                   else jmlm_step.make_sharded_mlm_train_step)
        step = factory(cfg, tx, m, P)
    else:
        if case["mode"] == "finetune":
            view = lambda t, _e: jfinetune._cast_esm(t["esm"], cfg.compute_dtype)  # noqa: E731
        else:
            alpha = jlora.default_alpha(RANK)
            view = lambda t, e: jlora.merge_lora(e, t["lora"], alpha)  # noqa: E731
        step = jmlm_step.make_sharded_mlm_finetune_step(cfg, tx, m, P, view,
                                                        packed=case["packed"])
    arrs = [jnp.asarray(a) for a in case["arrs"]]
    place = dp.tp_place(m) if model > 1 else None
    return dp.run_jax(step, tx, case, arrs[0], place, *arrs[1:])


@pytest.mark.parametrize("name", list(CASES))
def test_mlm_mesh_step_matches_jax_and_one_device(cases, world, name):
    jax_out = jax_step(cases[name])
    dp.check_case(cases[name], [r[name] for r in world.result()], jax_out)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_packed_rows_sharded_wire_equals_jax(n_shards):
    """``tokenize_packed_rows_sharded`` gives JAX's rows to the bit: token
    balance over the shards, all-<pad> filler rows, a truncated sequence
    (its <eos> kept)."""
    rng = np.random.default_rng(n_shards)
    seqs = dp.seqs(rng, 11, 3, 40) + dp.seqs(rng, 1, 70, 71)
    for row_len in (None, 64):
        with pytest.warns(UserWarning) if row_len else contextlib.nullcontext():
            got = packed_engine.tokenize_packed_rows_sharded(EsmTokenizer(), seqs, n_shards,
                                                             row_len=row_len)
        want = np.asarray(jpacked.tokenize_packed_rows_sharded(JaxTokenizer(), seqs, n_shards,
                                                               row_len=row_len))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


def _csv_rows(runs: Path) -> list[list[float]]:
    (run,) = list(runs.iterdir())
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert rows[0] == "Epoch,Train Loss,Validation Loss"
    return [[float(v) for v in r.split(",")] for r in rows[1:]]


@pytest.mark.parametrize("mesh_flags", [["--dp", "2", "--finetune"], ["--tp", "2"]],
                         ids=["dp2-finetune", "tp2"])
def test_cli_mlm_train_mesh_matches_jax(tmp_path, mesh_flags):
    """``cli.mlm_train`` on a mesh (spawned gloo ranks) against JAX's
    ``cli.mlm_train`` with the same flags, fixture, backbone npz and head
    (JAX's head init patched to the port's draw from --seed), at
    --mask-prob 1: every epoch's train and validation loss within the CSV's
    rounding (1e-4)."""
    argv, cfg = dp.cli_fixture(tmp_path)
    argv = [a for a in argv if a not in ("--dropout", "0.0")]
    argv += ["--prefix-a", "protein1", "--prefix-b", "protein2", "--batch-size", "4",
             "--epochs", "2", "--mask-prob", "1.0"] + mesh_flags
    head = cases_mod.to_numpy(esm2.init_lm_head(cfg, prng.set_seed(42), device="cpu"))
    assert mlm_train.main(argv + ["--device", "cpu", "--runs-dir", str(tmp_path / "port")]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jesm2, "init_lm_head",
                   lambda key, c: jax.tree.map(jnp.asarray, head))
        assert jmlm_train.main(argv + ["--runs-dir", str(tmp_path / "jax")]) == 0
    got, want = _csv_rows(tmp_path / "port"), _csv_rows(tmp_path / "jax")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1.01e-4, rtol=0)
