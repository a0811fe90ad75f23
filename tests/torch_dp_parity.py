"""JAX's side and the checks of the data-parallel parity tests
(``test_torch_dp.py``, ``test_torch_dp_filip.py``); the port's side, which
spawned ranks import, is ``tests/torch_dp_cases.py``.

JAX's ``shard_map`` steps run over 2 of conftest's 8 virtual CPU devices
with an optimizer that hands back its averaged gradients; optax's SGD and
Adam then apply them outside the step: one compile a case for both
optimizers, the same arithmetic as the step with either inside.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.parallel.mesh import make_mesh
from protein_clip_tpu.viz import plots as jplots
from protein_clip_tpu_torch.data.dataset import generate_datasets
from protein_clip_tpu_torch.data.synthetic import write_fixture
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.train import checkpoint
from tests import torch_dp_cases as cases_mod

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
AAS = list("LAGVSERTIDPKQNFYMHWC")


def seqs(rng, n, lo, hi):
    return ["".join(rng.choice(AAS, int(k))) for k in rng.integers(lo, hi, n)]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def noisy_adapters(adapters, rng):
    """LoRA adapters moved by seeded noise: B off 0, so A takes a gradient
    (a B of equal entries would give the o-projection's A the sum of a
    gradient that the LayerNorm after it makes 0)."""
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape,
                                                                              np.float32),
                        adapters)


def jax_mesh(data: int = 2, model: int = 1):
    return make_mesh(data=data, model=model, devices=jax.devices()[:data * model])


def tp_place(mesh):
    """(params, esm) -> both on JAX's Megatron shardings over ``mesh``'s
    'model' axis (``sharding.shard_params``: the backbone, and a finetune
    tree's f32 masters), as its ``MeshEngine.prepare_esm`` and
    ``prepare_params`` place them."""
    from protein_clip_tpu.parallel import sharding as jsharding

    def shard(tree):
        return jsharding.shard_params(mesh, tree, jsharding.esm_param_specs(tree))

    def place(params, esm):
        if "esm" in params:
            params = {**params, "esm": shard(params["esm"])}
        return params, (shard(esm) if esm else esm)

    return place


def capture():
    """An optax transformation whose state is the gradient it was given:
    the step hands back its averaged gradients and leaves the params."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def build(factory, *args, **kwargs):
    """A JAX step factory built at the cases' rows a chunk (packed steps
    read ``PCT_ROWS_PER_CHUNK`` when they are built, as the port's do)."""
    os.environ["PCT_ROWS_PER_CHUNK"] = cases_mod.ROWS_PER_CHUNK
    try:
        return factory(*args, **kwargs)
    finally:
        del os.environ["PCT_ROWS_PER_CHUNK"]


def jax_adam(clip: float = 0.0):
    adam = optax.adam(cases_mod.ADAM_LR)
    return optax.chain(optax.clip_by_global_norm(clip), adam) if clip else adam


def run_jax(step, tx, case: dict, batch, place=None, *extra) -> list:
    """[loss, averaged gradients, params after SGD, after Adam (with the
    case's clip)] of one JAX step over the case (flat trees); ``place``
    puts the params and backbone on the mesh's shardings, ``extra`` are
    arguments after the batch."""
    params = jax.tree.map(jnp.asarray, case["params"])
    esm = jax.tree.map(jnp.asarray, case["esm"])
    if place is not None:
        params, esm = place(params, esm)
    _, grads, loss = step(params, tx.init(params), esm, batch, *extra, jax.random.key(0))
    # the updates on one device, from the gradients as numpy (sharded ones
    # gathered)
    grads = jax.tree.map(jnp.asarray, np_tree(grads))
    params = jax.tree.map(jnp.asarray, case["params"])
    out = [float(loss), cases_mod.flat(np_tree(grads))]
    for opt in (optax.sgd(cases_mod.SGD_LR), jax_adam(case.get("clip", 0.0))):
        updates, _ = opt.update(grads, opt.init(params), params)
        out.append(cases_mod.flat(np_tree(optax.apply_updates(params, updates))))
    return out


def assert_step_close(got: dict, want: dict, grads: dict, wgrads: dict, what: str) -> None:
    """Loss within TOL (relative); params after SGD within TOL (the
    gradients within TOL / lr); after Adam within TOL, or, where a gradient
    is near 0, within the bound Adam puts on the entry: one step maps g to
    lr * g / (|g| + eps), so two gradients dg apart move it by up to lr * 2
    |dg| / (max |g| + eps) (``test_torch_finetune``'s
    ``assert_within_adam_bound``)."""
    np.testing.assert_allclose(got["sgd"][0], want["loss"], rtol=TOL, err_msg=what)
    np.testing.assert_allclose(got["adam"][0], want["loss"], rtol=TOL, err_msg=what)
    sgd, adam = cases_mod.flat(got["sgd"][1]), cases_mod.flat(got["adam"][1])
    assert sgd.keys() == want["sgd"].keys() == grads.keys()
    for k in sgd:
        np.testing.assert_allclose(sgd[k], want["sgd"][k], atol=TOL, rtol=0,
                                   err_msg=f"{what}: SGD {k}")
        g_max = np.maximum(np.abs(grads[k]), np.abs(wgrads[k]))
        bound = np.maximum(TOL, 1e-6 + cases_mod.ADAM_LR * 2 * np.abs(grads[k] - wgrads[k])
                           / (g_max + 1e-8))
        d = np.abs(adam[k] - want["adam"][k])
        assert (d <= bound).all(), (what, "Adam", k, float(d.max()))


def check_case(case: dict, ranks: list[dict], jax_out: list) -> None:
    """A case's checks: every rank equal to the bit (their params and
    gradients in the one-device layout: the model ranks' slices gathered);
    rank 0 against JAX's step and against the port's single-device step at
    the same global batch; the sharded eval against the single-device
    eval."""
    for opt in ("sgd", "adam", "grad"):
        for rank in ranks[1:]:
            assert ranks[0][opt][0] == rank[opt][0]
            other = cases_mod.flat(rank[opt][1])
            for k, v in cases_mod.flat(ranks[0][opt][1]).items():
                np.testing.assert_array_equal(v, other[k], err_msg=f"{opt}: {k}")
    for rank in ranks[1:]:
        assert ranks[0]["eval"] == rank["eval"]
    got = ranks[0]
    loss, jgrads, p_sgd, p_adam = jax_out
    assert_step_close(got, {"loss": loss, "sgd": p_sgd, "adam": p_adam}, got["grad"][1], jgrads,
                      "against JAX")
    if case["arch"] == "mlm":
        one = {opt: cases_mod.single_device_mlm(case, opt) for opt in ("sgd", "adam", "grad")}
        one_eval = cases_mod.single_device_mlm(case, "eval")
    else:
        one = {opt: cases_mod.single_device(case, opt) for opt in ("sgd", "adam", "grad")}
        one_eval = cases_mod.single_device_eval(case)
    assert_step_close(got, {"loss": one["sgd"][0], "sgd": cases_mod.flat(one["sgd"][1]),
                            "adam": cases_mod.flat(one["adam"][1])},
                      got["grad"][1], one["grad"][1], "against one device")
    np.testing.assert_allclose(got["eval"], one_eval, rtol=TOL)


def world_future(cases: dict, work: Path, n: int = 2):
    """The port's run of every case on ``n`` ranks, started in the
    background so it runs beside JAX's compiles: (a future of the ranks'
    results by rank, the pool to shut down)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    return pool.submit(cases_mod.spawn_world, cases, work, n), pool


# -- the CLIs ------------------------------------------------------------------

TINY_J = ["--esm-config", "tiny", "--esm-dtype", "float32", "--dropout", "0.0", "--seed", "42"]


def metrics(runs: Path) -> list[dict]:
    (run,) = list(runs.iterdir())
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def cli_fixture(d: Path) -> tuple[list[str], esm2.ESM2Config]:
    """A 40-family fixture and its cluster cache, written before the runs
    read them side by side, and the tiny f32 backbone as an npz both
    packages load: (the arguments that name them, the backbone config)."""
    data = d / "data"
    write_fixture(data, prefix1="protein1", prefix2="protein2", n_families=40, seed=42)
    generate_datasets(data, "protein1", "protein2", seed=42, max_sequence_length=2000)
    cfg = esm2.ESM2Config.tiny(compute_dtype=torch.float32)
    checkpoint.export_npz(d / "esm.npz", esm2.init_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu"))
    return TINY_J + ["--data-dir", str(data), "--esm-weights", str(d / "esm.npz")], cfg


def run_clis(d: Path, jax_main, port_main, module: str, argv: list[str], patches: dict,
             coordinator: bool = False) -> dict[str, list[dict]]:
    """metrics.jsonl of JAX's CLI with ``argv`` (in this process, its
    inits patched by ``patches``: {(module, name): value}, its figures,
    which cost it 14 s and hold no loss, not drawn), of the port's
    (ranks it spawns) and, with ``coordinator``, of the port's as two
    processes of one rank each joined through --coordinator, run side by
    side."""
    port_argv = argv + ["--device", "cpu"]
    procs = []
    if coordinator:
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = str(REPO)
        address = f"127.0.0.1:{cases_mod.distributed.free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *port_argv, "--runs-dir", str(d / "coordinator"),
             "--coordinator", address, "--num-processes", "2", "--process-id", str(i)],
            cwd=d, env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(2)]
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            spawned = pool.submit(port_main, port_argv + ["--runs-dir", str(d / "spawned")])
            with pytest.MonkeyPatch.context() as mp:
                for (mod, name), value in patches.items():
                    mp.setattr(mod, name, value)
                for name in ("plot_clustering", "plot_protein_lengths", "plot_loss_curves",
                             "plot_embedding_cosine_similarities"):
                    mp.setattr(jplots, name, lambda *a, **k: None)
                assert jax_main(argv + ["--runs-dir", str(d / "jax")]) == 0
            assert spawned.result() == 0
        for p in procs:
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            p.kill()
    return {k: metrics(d / k) for k in ("jax", "spawned", "coordinator")[:3 if procs else 2]}


def assert_metrics_close(got: list[dict], want: list[dict]) -> None:
    """Every epoch's train and validation loss within 1e-5 of JAX's (the
    unrounded ones of metrics.jsonl; the CSV rounds them to 4 places)."""
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, err_msg=key)
