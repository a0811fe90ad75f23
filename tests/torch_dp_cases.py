"""The port's side of the data-parallel parity tests (``test_torch_dp.py``,
``test_torch_dp_filip.py``): the cases run in a spawned world of gloo
ranks on the CPU, and each rank writes what it got. Imports torch and the
port only (a spawned rank imports this module, never JAX).

A case is a dict of plain values: ``arch`` ("clip" | "filip"), ``mode``
("frozen" | "finetune" | "lora"), ``packed``, ``cfg`` (``EngineConfig``
keywords beside the model), ``use_dcl``, the trainable tree ``params`` and
the frozen backbone ``esm`` as numpy trees, and the global batch's
``peps``, ``recs``. Each case runs one step of the ``MeshEngine`` with SGD
and, from the same start, one with Adam, and its eval step on the batch.
"""

from __future__ import annotations

import copy
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2, filip
from protein_clip_tpu_torch.parallel import distributed
from protein_clip_tpu_torch.parallel.engine import MeshEngine
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_engine, filip_finetune,
                                          filip_lora, finetune, lora, optimizer, packed_engine)

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


def make_optimizer(name: str, params):
    if name == "grad":
        return Capture(params)
    return SGD(params) if name == "sgd" else optimizer.adam(ADAM_LR).init(params)


def outcome(params, opt_state) -> dict:
    """What a step left: the gradients it applied (``Capture``), else the
    params."""
    return opt_state.grads if isinstance(opt_state, Capture) else to_numpy(params)


def run_case(case: dict) -> dict:
    """{"sgd": (loss, params), "adam": (loss, params), "grad": (loss,
    averaged gradients), "eval": loss} of this rank's run of the case."""
    cfg = engine_config(case)
    engine = MeshEngine(data=distributed.world_size(), arch=case["arch"], mode=case["mode"],
                        packed=case["packed"])
    batch = engine.make_prepare(cfg, EsmTokenizer())(case["peps"], case["recs"])
    esm = tensors(case["esm"])
    out = {}
    for name in ("sgd", "adam", "grad"):
        params = tensors(case["params"])
        params, state, loss = engine.make_train_step(cfg)(
            params, make_optimizer(name, params), esm, batch, torch.Generator().manual_seed(0))
        out[name] = (float(loss), outcome(params, state))
    out["eval"] = float(engine.make_eval_step(cfg)(tensors(case["params"]), esm, batch))
    return out


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


def run_world(local_rank: int, case_file: str, out_dir: str) -> None:
    """A rank's entry (``distributed.spawn``): every case of the file, then
    ``pmean_buckets`` (under "pmean")."""
    os.environ["PCT_ROWS_PER_CHUNK"] = ROWS_PER_CHUNK
    torch.use_deterministic_algorithms(True)
    with open(case_file, "rb") as f:
        cases = pickle.load(f)
    results = {name: run_case(case) for name, case in cases.items()}
    results["pmean"] = pmean_buckets()
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
            params, make_optimizer(opt_name, params), tensors(case["esm"]), single_batch(case),
            torch.Generator().manual_seed(0))
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
