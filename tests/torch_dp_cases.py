"""The port's side of the data-parallel parity tests (``test_torch_dp.py``,
``test_torch_dp_filip.py``): the cases run in a spawned world of gloo
ranks on the CPU, and each rank writes what it got. Imports torch and the
port only (a spawned rank imports this module, never JAX).

A case is a dict of plain values: ``arch`` ("clip" | "filip"), ``mode``
("frozen" | "finetune" | "lora"), ``packed``, ``cfg`` (``EngineConfig``
keywords beside the model), ``use_dcl``, the trainable tree ``params`` and
the frozen backbone ``esm`` as numpy trees, and the global batch's
``peps``, ``recs``; optionally ``tp`` (the mesh's model axis; the data
axis is the world over it) and ``clip`` (Adam's global-norm clip). Each
case runs one step of the ``MeshEngine`` with SGD and, from the same
start, one with Adam, and its eval step on the batch; a rank reports its
params and gradients in the one-device layout (its slices gathered over
the model group). An MLM case (``arch`` "mlm") runs
``parallel/mlm_step.py``'s step of ``mode`` ("head" | "finetune" |
"lora") on the global batch ``arrs`` with each data shard's ``masks``.
"""

from __future__ import annotations

import copy
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from protein_clip_tpu_torch.cli import mlm_train
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2, filip
from protein_clip_tpu_torch.parallel import distributed, mlm_step, sharding
from protein_clip_tpu_torch.parallel.engine import MeshEngine
from protein_clip_tpu_torch.parallel.mesh import make_mesh
from protein_clip_tpu_torch.parallel.step import tp_model_config
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_engine, filip_finetune,
                                          filip_lora, finetune, lora, mlm_engine, optimizer,
                                          packed_engine)

SGD_LR = 5e-2
ADAM_LR = 1e-3
ROWS_PER_CHUNK = "2"       # PCT_ROWS_PER_CHUNK: several chunks a pass on the tiny shards


class SGD:
    """Plain SGD over a tree's leaves, with ``OptState``'s ``leaves`` and
    ``apply``: the step the gradient scale shows in (Adam hides it)."""

    def __init__(self, params, lr: float = SGD_LR):
        self.leaves = [t.requires_grad_(True) for t in optimizer.tree_leaves(params)]
        self.lr = lr

    def apply(self) -> None:
        with torch.no_grad():
            for t in self.leaves:
                if t.grad is not None:
                    t.sub_(self.lr * t.grad)
                t.grad = None


class Capture:
    """An optimizer state whose ``apply`` keeps the (averaged) gradients,
    by ``flat`` name, and leaves the params as they are."""

    def __init__(self, params):
        self.named = flat(params)
        self.leaves = [t.requires_grad_(True) for t in self.named.values()]
        self.grads: dict[str, np.ndarray] = {}

    def apply(self) -> None:
        for k, t in self.named.items():
            self.grads[k] = (np.zeros(t.shape, np.float32) if t.grad is None
                             else t.grad.detach().numpy().copy())
            t.grad = None


def model_config(case: dict):
    esm_cfg = esm2.ESM2Config.tiny()
    kind = filip.FILIPConfig if case["arch"] == "filip" else clip.CLIPConfig
    return kind(input_dim=esm_cfg.hidden_size, embedding_dim=16, dropout=0.0, esm=esm_cfg)


def engine_config(case: dict) -> clip_engine.EngineConfig:
    return clip_engine.EngineConfig(model=model_config(case), remat=False, packed=case["packed"],
                                    filip_use_dcl=case.get("use_dcl", False), **case["cfg"])


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def tensors(tree):
    """A numpy tree as CPU tensors of their own (``from_numpy_tree`` shares
    the arrays' memory, which a step would update in place)."""
    return checkpoint.from_numpy_tree(copy.deepcopy(tree), "cpu") if tree else {}



def single_engine(case: dict):
    """The port's single-device engine module of the case's mode."""
    return {("clip", "frozen"): clip_engine, ("clip", "finetune"): finetune,
            ("clip", "lora"): lora, ("filip", "frozen"): filip_engine,
            ("filip", "finetune"): filip_finetune,
            ("filip", "lora"): filip_lora}[case["arch"], case["mode"]]


def single_batch(case: dict) -> dict:
    """The whole global batch on the single-device wire of the case."""
    tok = EsmTokenizer()
    if case["packed"]:
        return packed_engine.tokenize_packed(tok, case["peps"], case["recs"])
    return clip_engine.tokenize_pair_batch(tok, case["peps"], case["recs"])


def make_optimizer(name: str, params, clip: float = 0.0):
    if name == "grad":
        return Capture(params)
    if name == "sgd":
        return SGD(params)
    return optimizer.build(ADAM_LR, grad_clip=clip).init(params)


def outcome(params, opt_state, mesh=None) -> dict:
    """What a step left: the gradients it applied (``Capture``), else the
    params, in the one-device layout (gathered over ``mesh``'s model
    group)."""
    if isinstance(opt_state, Capture):
        grads = opt_state.grads
        if mesh is not None and mesh.model > 1:
            grads = to_numpy(sharding.gather_params(
                mesh, {k: torch.from_numpy(v) for k, v in grads.items()}))
        return grads
    if mesh is not None and mesh.model > 1:
        params = sharding.gather_params(mesh, params)
    return to_numpy(params)


def run_case(case: dict) -> dict:
    """{"sgd": (loss, params), "adam": (loss, params), "grad": (loss,
    averaged gradients), "eval": loss} of this rank's run of the case."""
    if case["arch"] == "mlm":
        return run_mlm_case(case)
    cfg = engine_config(case)
    tp = case.get("tp", 1)
    engine = MeshEngine(data=distributed.world_size() // tp, model=tp, arch=case["arch"],
                        mode=case["mode"], packed=case["packed"], esm=cfg.model.esm)
    batch = engine.make_prepare(cfg, EsmTokenizer())(case["peps"], case["recs"])
    esm = engine.prepare_esm(tensors(case["esm"]))
    out = {}
    for name in ("sgd", "adam", "grad"):
        params = engine.prepare_params(tensors(case["params"]))
        params, state, loss = engine.make_train_step(cfg)(
            params, make_optimizer(name, params, case.get("clip", 0.0)), esm, batch,
            torch.Generator().manual_seed(0))
        out[name] = (float(loss), outcome(params, state, engine.mesh))
    out["eval"] = float(engine.make_eval_step(cfg)(engine.prepare_params(tensors(case["params"])),
                                                   esm, batch))
    return out


def mlm_view(mode: str, cfg):
    """The MLM step's backbone view of a mode (``cli.mlm_train``'s)."""
    if mode == "finetune":
        return lambda t, _: finetune._cast_esm(t["esm"], cfg.compute_dtype)
    if mode == "lora":
        return lambda t, e: lora.merge_lora(
            e, t["lora"], lora.default_alpha(next(iter(t["lora"].values()))["a"].shape[-1]),
            cfg.model_axis)
    return None


def run_mlm_case(case: dict) -> dict:
    """An MLM case on this rank's mesh: the rank's rows of ``arrs`` and its
    data index's masks through ``mlm_step.make_sharded_mlm_steps``."""
    tp = case.get("tp", 1)
    cfg = esm2.ESM2Config.tiny()
    mesh = make_mesh(data=distributed.world_size() // tp, model=tp, esm_cfg=cfg)
    arrs = tuple(torch.from_numpy(a) for a in case["arrs"])
    inputs = mlm_train.batch_inputs(mlm_step.rank_rows(arrs, mesh), case["packed"])
    masks = tuple(torch.from_numpy(a) for a in case["masks"][mesh.index])
    view = mlm_view(case["mode"], tp_model_config(cfg, mesh))
    train, evaluate = mlm_step.make_sharded_mlm_steps(cfg, mesh, case["mode"], view)
    esm = sharding.shard_params(mesh, tensors(case["esm"]))
    out = {}
    for name in ("sgd", "adam", "grad"):
        trainable = sharding.shard_params(mesh, tensors(case["params"]))
        trainable, state, loss = train(trainable, make_optimizer(name, trainable), esm, inputs,
                                       masks)
        out[name] = (float(loss), outcome(trainable, state, mesh))
    out["eval"] = float(evaluate(sharding.shard_params(mesh, tensors(case["params"])), esm,
                                 inputs, masks))
    return out


def single_device_mlm(case: dict, opt_name: str) -> tuple[float, dict]:
    """The single-device MLM step over the whole batch (the shards' rows
    and masks joined): (loss, ``outcome``)."""
    cfg = esm2.ESM2Config.tiny()
    inputs = mlm_train.batch_inputs(tuple(torch.from_numpy(a) for a in case["arrs"]),
                                    case["packed"])
    masks = tuple(torch.from_numpy(np.concatenate([m[i] for m in case["masks"]]))
                  for i in range(2))
    train, evaluate = mlm_engine.make_steps(cfg, case["mode"], mlm_view(case["mode"], cfg))
    if opt_name == "eval":
        return float(evaluate(tensors(case["params"]), tensors(case["esm"]), inputs, masks))
    trainable = tensors(case["params"])
    trainable, state, loss = train(trainable, make_optimizer(opt_name, trainable),
                                   tensors(case["esm"]), inputs, masks)
    return float(loss), outcome(trainable, state)


def tp_forwards() -> dict:
    """On a mesh of model axis 2 (data the world over it): the tiny
    backbone's slices gathered back (to the bit), and the backbone's
    forward on the rank's slices against the one-device forward on the
    same batch: f32, bf16 and int8 (w8a8 over the bf16 tree: to the bit),
    with each rank's bytes of the sharded tree beside the whole tree's."""
    cfg32 = esm2.ESM2Config.tiny()
    mesh = make_mesh(data=distributed.world_size() // 2, model=2, esm_cfg=cfg32)
    full = esm2.init_params(cfg32, torch.Generator().manual_seed(3), device="cpu")
    back = sharding.gather_params(mesh, sharding.shard_params(mesh, full))
    round_trip = all(torch.equal(a, b) for a, b in zip(optimizer.tree_leaves(full),
                                                       optimizer.tree_leaves(back)))
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(4, 24, (3, 20)).astype(np.int32))
    ids[:, 0] = 0
    mask = torch.ones_like(ids)
    mask[1, 14:] = 0
    ids[1, 13] = 2
    out = {"round_trip": round_trip}
    for name, dtype, tree in (("f32", torch.float32, full),
                              ("bf16", torch.bfloat16, esm2.cast_params(full, torch.bfloat16)),
                              ("int8", torch.bfloat16,
                               esm2.quantize_params(esm2.cast_params(full, torch.bfloat16)))):
        cfg = esm2.ESM2Config.tiny(compute_dtype=dtype)
        with torch.no_grad():
            one = esm2.forward(tree, ids, mask, cfg)
            shards = sharding.shard_params(mesh, tree)
            got = esm2.forward(shards, ids, mask, tp_model_config(cfg, mesh))
        out[name] = {"one": one.float().numpy(), "tp": got.float().numpy(),
                     "bytes": sharding.nbytes(shards), "full_bytes": sharding.nbytes(tree)}
    return out


def cli_resume(argv: list[str], runs: str) -> None:
    """A CLI training run of this world (``cli.main``, whose ranks are this
    world's) for two epochs under ``runs``/full, and for one under
    ``runs``/cut resumed to two from its snapshot: rank 0 writes both."""
    from protein_clip_tpu_torch.cli import main

    assert main.main(argv + ["--epochs", "2", "--runs-dir", f"{runs}/full"]) == 0
    assert main.main(argv + ["--epochs", "1", "--runs-dir", f"{runs}/cut"]) == 0
    cut = distributed.broadcast_object(
        str(next(Path(f"{runs}/cut").iterdir())) if distributed.is_primary() else None)
    assert main.main(argv + ["--epochs", "2", "--runs-dir", f"{runs}/cut",
                             "--resume-dir", cut]) == 0




# pmean_grads' leaves: (shape, dtype, gradient stored transposed); the last
# leaf has no gradient
PMEAN_LEAVES = (((3, 5), torch.float32, False), ((40,), torch.float32, False),
                ((7,), torch.float64, False), ((3, 2), torch.float32, True),
                ((100,), torch.float32, False), ((2,), torch.float64, False), ((4,), None, False))
PMEAN_BUCKET_BYTES = 64


def pmean_draws() -> list[torch.Tensor | None]:
    """The seeded gradient draw of each PMEAN_LEAVES leaf (None: no gradient)."""
    rng = np.random.default_rng(5)
    return [None if dtype is None
            else torch.from_numpy(rng.standard_normal(shape)).to(dtype)
            for shape, dtype, _ in PMEAN_LEAVES]


def pmean_buckets() -> list[np.ndarray | None]:
    """pmean_grads over PMEAN_LEAVES in buckets of PMEAN_BUCKET_BYTES (two
    dtypes; the 160- and 400-byte gradients reduced in place, the rest in
    buckets; one gradient not contiguous), rank r's gradients r + 1 times
    the draw: the averaged gradients."""
    leaves = []
    for (shape, dtype, transposed), draw in zip(PMEAN_LEAVES, pmean_draws()):
        t = torch.zeros(shape, dtype=dtype or torch.float32)
        if draw is not None:
            g = draw * (distributed.rank() + 1)
            t.grad = g.t().contiguous().t() if transposed else g
        leaves.append(t)
    bucket, distributed.BUCKET_BYTES = distributed.BUCKET_BYTES, PMEAN_BUCKET_BYTES
    try:
        distributed.pmean_grads(leaves)
    finally:
        distributed.BUCKET_BYTES = bucket
    return [None if t.grad is None else t.grad.numpy() for t in leaves]


EXTRAS = {"pmean": pmean_buckets, "tp_forwards": tp_forwards, "cli_resume": cli_resume}


def run_world(local_rank: int, case_file: str, out_dir: str) -> None:
    """A rank's entry (``distributed.spawn``): every case of the file, then
    its ``__extras__`` ({``EXTRAS`` name: keywords}; ``pmean_buckets`` by
    default)."""
    os.environ["PCT_ROWS_PER_CHUNK"] = ROWS_PER_CHUNK
    torch.use_deterministic_algorithms(True)
    with open(case_file, "rb") as f:
        cases = pickle.load(f)
    extras = cases.pop("__extras__", {"pmean": {}})
    results = {name: run_case(case) for name, case in cases.items()}
    for name, kwargs in extras.items():
        results[name] = EXTRAS[name](**kwargs)
    results["__work__"] = out_dir
    with open(Path(out_dir) / f"rank{distributed.rank()}.pkl", "wb") as f:
        pickle.dump(results, f)


def spawn_world(cases: dict, work: Path, n: int = 2) -> list[dict]:
    """Run ``cases`` on ``n`` gloo ranks spawned from this process; each
    rank's results, by rank."""
    work.mkdir(parents=True, exist_ok=True)
    case_file = work / "cases.pkl"
    with open(case_file, "wb") as f:
        pickle.dump(cases, f)
    distributed.spawn(run_world, (str(case_file), str(work)), n, world=n,
                      init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
                      backend="gloo", device_type="cpu")
    out = []
    for r in range(n):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def single_device(case: dict, opt_name: str) -> tuple[float, dict]:
    """The port's single-device step on the whole global batch: (loss,
    ``outcome``) of one step (the reference the mesh step equals)."""
    os.environ["PCT_ROWS_PER_CHUNK"] = ROWS_PER_CHUNK
    try:
        params = tensors(case["params"])
        params, state, loss = single_engine(case).make_train_step(engine_config(case))(
            params, make_optimizer(opt_name, params, case.get("clip", 0.0)),
            tensors(case["esm"]), single_batch(case), torch.Generator().manual_seed(0))
        return float(loss), outcome(params, state)
    finally:
        del os.environ["PCT_ROWS_PER_CHUNK"]


def single_device_eval(case: dict) -> float:
    """The port's single-device eval step of the case's mode on the whole
    batch, from the case's params."""
    step = single_engine(case).make_eval_step(engine_config(case))
    return float(step(tensors(case["params"]), tensors(case["esm"]), single_batch(case)))


def flat(tree, prefix: str = "") -> dict:
    """A tree's leaves by their path ("heads/pep/w"); flat trees pass."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}
