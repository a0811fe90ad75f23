"""The port's tensor parallelism (``protein_clip_tpu_torch/parallel``: the
'model' mesh axis, ``sharding.py``, the sharded backbone forward of
``models/esm2.py``) against the JAX package's Megatron-sharded steps, on
the CPU.

The port's steps run in spawned worlds of gloo ranks (``tests/
torch_dp_cases.py``, which imports no JAX): two ranks for a (1, 2) mesh
(tp = 2), four for a (2, 2) one (dp = 2 x tp = 2). JAX's run over a (2, 2)
mesh of conftest's virtual CPU devices with the backbone (and a finetune
tree's f32 masters) on ``sharding.esm_param_specs``' shardings: the step
over the global batch does not depend on the data axis, and on a (1, 2)
mesh of virtual CPU devices JAX's unfrozen steps stop in XLA's SPMD
partitioner ("Cross-partition allreduce must be in (partial) manual
partitioning mode"). The tiny backbone in f32, dropout 0, params crossed
as numpy. Every unpacked CLIP and FILIP mode (frozen, finetune, LoRA) at
both meshes, and the finetune step under Adam with a global-norm clip.

Per case: the loss within 1e-5 of JAX's and of the port's one-device step
at the same global batch; the params after one SGD step and one Adam step
within 1e-5 (Adam: or the bound it puts on an entry whose gradient is near
0); every rank's loss, gradients and params equal to the bit (the split
leaves compared after ``gather_params``); the sharded eval within 1e-5 of
the one-device eval. Also: ``shard_params`` / ``gather_params`` round trip
to the bit; the int8 forward at tp = 2 equal to the one-device int8
forward to the bit, the f32 and bf16 ones close; a rank's bytes of the
sharded backbone; ``cli.main_2protein --tp 2`` against JAX's on one
fixture; a tp = 2 run resumed from its snapshot equal to the unbroken run
to the bit; the refusals that stay.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import main_2protein as jmain
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.parallel import filip_finetune_step as jffs
from protein_clip_tpu.parallel import filip_step as jfilip_step
from protein_clip_tpu.parallel import finetune_step as jft_step
from protein_clip_tpu.parallel import step as jstep
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu_torch.cli import main_2protein
from protein_clip_tpu_torch.models import clip
from protein_clip_tpu_torch.parallel import engine, mesh, sharding
from protein_clip_tpu_torch.train import optimizer
from protein_clip_tpu_torch.utils import prng
from tests import torch_dp_cases as cases_mod
from tests import torch_dp_parity as dp

CFG = {"clip": dict(batch_size=4, accumulated_batches=2, num_chunks=4),
       "filip": dict(batch_size=8, accumulated_batches=1, num_chunks=4)}
MODES = ("frozen", "finetune", "lora")
# name -> (arch, mode, world); a world of 2 ranks is a (1, 2) mesh, of 4 a (2, 2) one
CASES = {f"{arch}-{mode}-{'tp2' if world == 2 else 'dp2tp2'}": (arch, mode, world)
         for world in (2, 4) for arch in ("clip", "filip") for mode in MODES}
CLIP_CASE = "clip-finetune-tp2-clip"
CLIP_NORM = 0.05   # below the step's gradient norm: the clip scales the update
RESUME_ARGV = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu", "--dropout",
               "0.0", "--synthetic-fixture", "--fixture-families", "40", "--batch-size", "4",
               "--accumulated-batches", "2", "--num-chunks", "2", "--length-groups", "1",
               "--tp", "2", "--finetune", "--grad-clip", "0.5"]


def _jmcfg(arch):
    esm_cfg = jesm2.ESM2Config.tiny()
    kind = jfilip.FILIPConfig if arch == "filip" else jclip.CLIPConfig
    return kind(input_dim=esm_cfg.hidden_size, embedding_dim=16, dropout=0.0, esm=esm_cfg)


@pytest.fixture(scope="module")
def cases():
    """name -> case: the tiny backbone and heads from JAX's init, noisy LoRA
    adapters, a global batch of 8 pairs; the world each runs in."""
    out = {}
    for arch in ("clip", "filip"):
        jmcfg = _jmcfg(arch)
        jesm = dp.np_tree(jesm2.init_params(jax.random.key(1), jmcfg.esm))
        jheads = dp.np_tree((jfilip if arch == "filip" else jclip).init_params(
            jax.random.key(2), jmcfg))
        rng = np.random.default_rng(23 if arch == "clip" else 24)
        peps, recs = dp.seqs(rng, 8, 5, 15), dp.seqs(rng, 8, 10, 40)
        adapters = dp.noisy_adapters(jlora.init_lora(jax.random.key(3), jesm, 2), rng)
        trees = {"frozen": (jheads, jesm),
                 "finetune": (dp.np_tree(jfinetune.init_params(jesm, jheads)), {}),
                 "lora": ({"lora": adapters, "heads": jheads}, jesm)}
        for name, (a, mode, world) in CASES.items():
            if a == arch:
                out[name] = dict(arch=arch, mode=mode, packed=False, cfg=CFG[arch], tp=2,
                                 world=world, params=trees[mode][0], esm=trees[mode][1],
                                 peps=peps, recs=recs)
    out[CLIP_CASE] = {**out["clip-finetune-tp2"], "clip": CLIP_NORM}
    return out


@pytest.fixture(scope="module")
def worlds(cases, tmp_path_factory):
    """The port's runs: every tp = 2 case in one world of two ranks (and
    the resumed CLI run), every dp = 2 x tp = 2 case in one of four, each
    with ``tp_forwards``; run in the background beside JAX's steps."""
    futures, pools = {}, []
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"tp_world{world}")
        mine = {k: v for k, v in cases.items() if v["world"] == world}
        mine["__extras__"] = {"tp_forwards": {}}
        if world == 2:
            mine["__extras__"]["cli_resume"] = {"argv": RESUME_ARGV + ["--data-dir",
                                                                       str(work / "data")],
                                                "runs": str(work / "resume")}
        future, pool = dp.world_future(mine, work, world)
        futures[world] = future
        pools.append(pool)
    yield futures
    for pool in pools:
        pool.shutdown()


def jax_step(case: dict) -> list:
    jcfg = jengine.EngineConfig(model=_jmcfg(case["arch"]), remat=False, **case["cfg"])
    m = dp.jax_mesh(2, 2)
    tx = dp.capture()
    if case["arch"] == "clip":
        factory = {"frozen": jstep.make_sharded_train_step,
                   "finetune": jft_step.make_sharded_finetune_step,
                   "lora": jft_step.make_sharded_lora_step}[case["mode"]]
        step = factory(jcfg, tx, m)
    elif case["mode"] == "frozen":
        step = jfilip_step.make_sharded_filip_train_step(jcfg, tx, m)
    else:
        step = jffs.make_sharded_filip_finetune_step(jcfg, tx, m, packed=False,
                                                     lora=case["mode"] == "lora")
    batch = jstep.shard_batch(m, jengine.tokenize_pair_batch(JaxTokenizer(), case["peps"],
                                                             case["recs"]))
    return dp.run_jax(step, tx, case, batch, dp.tp_place(m))


@pytest.mark.parametrize("name", list(CASES) + [CLIP_CASE])
def test_tp_step_matches_jax_and_one_device(cases, worlds, name):
    case = cases[name]
    jax_out = jax_step(case)
    dp.check_case(case, [r[name] for r in worlds[case["world"]].result()], jax_out)


@pytest.mark.parametrize("world", [2, 4])
def test_shards_round_trip_and_int8_forward_to_the_bit(worlds, world):
    """On every rank: the tiny backbone cut to its slices and gathered back
    is the backbone to the bit; the int8 forward on the slices (the row
    linears' per-token scale from an all-reduce MAX, their s32 partials
    summed in int32) equals the one-device int8 forward to the bit; the f32
    forward within 2e-6 of the one-device one, bf16 within 4 bf16 ulps of
    the hidden state's scale (its partials summed in f32 and rounded once
    where one device rounds the whole product once); a rank holds half of
    every split leaf."""
    for rank in worlds[world].result():
        got = rank["tp_forwards"]
        assert got["round_trip"]
        np.testing.assert_array_equal(got["int8"]["tp"], got["int8"]["one"])
        np.testing.assert_allclose(got["f32"]["tp"], got["f32"]["one"], atol=2e-6, rtol=0)
        scale = float(np.abs(got["bf16"]["one"]).max())
        assert float(np.abs(got["bf16"]["tp"] - got["bf16"]["one"]).max()) <= 4 * 2 ** -8 * scale
        for name in ("f32", "bf16", "int8"):
            assert got[name]["bytes"] < got[name]["full_bytes"]
    f32 = worlds[world].result()[0]["tp_forwards"]["f32"]
    # tiny: the split leaves (q, k, v, o, wi, wo weights, q, k, v, wi biases) halve
    H, I, L, V = 64, 128, 2, 33
    split = L * (4 * H * H + 2 * H * I + 3 * H + I) * 4
    assert f32["full_bytes"] - f32["bytes"] == split // 2


def test_mesh_guards_on_the_model_axis():
    """The model axis must divide the backbone's heads and FFN width
    (ValueError naming both numbers); a mesh needs its ranks; a packed
    mesh with a model axis is refused with the TPU package's reason; the
    Megatron specs by leaf (the int8 tree's too) and a rank's slices;
    sharded weights without the config's model axis raise."""
    from protein_clip_tpu_torch.models import esm2

    cfg = esm2.ESM2Config.tiny()
    with pytest.raises(ValueError, match="--tp.*num_heads, 4"):
        mesh.make_mesh(model=3, esm_cfg=cfg)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.make_mesh(data=1, model=2)
    with pytest.raises(ValueError, match="DP-only"):
        engine.MeshEngine(model=2, packed=True)
    one = mesh.Mesh(data=1, model=2, model_index=1)
    params = esm2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    half = sharding.shard_params(one, params)
    assert half["layers"]["attn"]["q"]["w"].shape == (2, 64, 32)
    assert half["layers"]["attn"]["o"]["w"].shape == (2, 32, 64)
    assert torch.equal(half["layers"]["ffn"]["wi"]["b"], params["layers"]["ffn"]["wi"]["b"][:, 64:])
    assert half["layers"]["ffn"]["wo"]["b"] is params["layers"]["ffn"]["wo"]["b"]
    specs = sharding.esm_param_specs(params)
    assert (specs["layers"]["attn"]["q"], specs["layers"]["attn"]["o"]) == (
        {"w": -1, "b": -1}, {"w": -2, "b": None})
    assert specs["embed"]["word"] is None and specs["layers"]["ffn"]["ln"]["w"] is None
    assert sharding.esm_param_specs(esm2.quantize_params(params))["layers"]["ffn"]["wo"] == {
        "w_q": -2, "w_s": None, "b": None}
    assert set(optimizer.tree_leaves(sharding.head_param_specs({"a": {"b": 1}, "c": 2}))) == {None}
    ids = torch.ones(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="model_axis disagree"):
        esm2.forward(half, ids, ids, cfg)


def _losses(runs: Path) -> list[dict]:
    (run,) = list(runs.iterdir())
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli.main_2protein --tp 2``: JAX's (its heads' init patched to the
    heads the port's CLI draws from --seed) and the port's spawned ranks."""
    d = tmp_path_factory.mktemp("tp_cli")
    argv, esm_cfg = dp.cli_fixture(d)
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, dropout=0.0, esm=esm_cfg)
    heads = cases_mod.to_numpy(clip.init_params(mcfg, prng.set_seed(42), device="cpu"))
    argv += ["--epochs", "1", "--batch-size", "4", "--accumulated-batches", "2",
             "--num-chunks", "2", "--length-groups", "1", "--tp", "2"]
    return dp.run_clis(d, jmain.main, main_2protein.main,
                       "protein_clip_tpu_torch.cli.main_2protein", argv,
                       {(jclip, "init_params"): lambda key, cfg: jax.tree.map(jax.numpy.asarray,
                                                                              heads)})


def test_cli_tp2_matches_jax(cli_runs):
    dp.assert_metrics_close(cli_runs["spawned"], cli_runs["jax"])


def test_cli_tp2_resumed_equals_unbroken_run(worlds):
    """``cli.main --tp 2 --finetune --grad-clip`` in the two-rank world
    (deterministic algorithms): one epoch, then resumed to two from its
    snapshot (written in the one-device layout, the masters and Adam's
    moments gathered), equals the unbroken two-epoch run to the bit: the
    losses, best_model.npz and the snapshot's params."""
    worlds[2].result()
    runs = Path(worlds[2].result()[0]["__work__"]) / "resume"
    (cut,), (full,) = (list((runs / k).iterdir()) for k in ("cut", "full"))
    drop = lambda rows: [{k: v for k, v in r.items() if k != "seconds"} for r in rows]  # noqa
    assert drop(_losses(runs / "cut")) == drop(_losses(runs / "full"))
    assert len(_losses(runs / "cut")) == 2
    a, b = np.load(cut / "best_model.npz"), np.load(full / "best_model.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sa = torch.load(cut / "state" / "epoch_2.pt", weights_only=False)
    sb = torch.load(full / "state" / "epoch_2.pt", weights_only=False)
    assert sa["params"]["esm/layers/attn/q/w"].shape == (2, 64, 64)
    for k in sa["params"]:
        assert torch.equal(sa["params"][k], sb["params"][k]), k
