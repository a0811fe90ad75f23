"""The port's serving path on the CPU against the JAX package's.

The JAX package writes the heads checkpoint and the ESM weights (tiny
config, float32); the port's ``cli.serve`` serves them with ``--device
cpu``. ``/embed`` must match the JAX ``cli.embed.embed_sequences`` on the
same sequences within 1e-5 (float32, sums in another order); the binary
wire must equal the JSON path bit for bit; ``/topk`` must rank as numpy
does over the index; 8 concurrent clients must be coalesced.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.cli.embed import embed_sequences as jax_embed_sequences
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train.checkpoint import export_npz as jax_export_npz

REPO = Path(__file__).resolve().parent.parent
AAS = "LAGVSERTIDPKQNFYMHWC"
ATOL = 1e-5
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]


def _seqs(rng, n, lo=5, hi=40):
    return ["".join(rng.choice(list(AAS), int(L))) for L in rng.integers(lo, hi, n)]


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    esm_cfg = jcommon.esm_config("tiny", "float32")
    mcfg = jclip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    heads = jclip.init_params(jax.random.key(3), mcfg)
    esm = jesm2.init_params(jax.random.key(4), esm_cfg)
    jax_export_npz(d / "best_model.npz", heads)
    jax_export_npz(d / "esm.npz", esm)
    corpus = _seqs(np.random.default_rng(0), 24)
    (d / "corpus.fasta").write_text("".join(f">c{i}\n{s}\n" for i, s in enumerate(corpus)))
    return {"dir": d, "heads": heads, "esm": esm, "mcfg": mcfg, "corpus": corpus}


def _jax_embed(files, seqs, side, batch_size=16):
    return jax_embed_sequences(files["heads"], files["esm"], seqs, side, files["mcfg"],
                               JaxTokenizer(), batch_size=batch_size, pad_batch=True)


@pytest.fixture(scope="module")
def served(model_files):
    from protein_clip_tpu_torch.cli import embed, serve

    d = model_files["dir"]
    weights = ["--checkpoint", str(d / "best_model.npz"), "--esm-weights", str(d / "esm.npz")]
    assert embed.main(TINY + weights + ["--fasta", str(d / "corpus.fasta"), "--side", "rec",
                                        "--out", str(d / "index.npz")]) == 0
    args = serve.build_argparser().parse_args(
        TINY + weights + ["--index", str(d / "index.npz"), "--port", "0", "--batch-size", "8"])
    server = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _call(base, path, payload=None, headers=None):
    req = urllib.request.Request(
        base + path, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _embed(base, seqs, side):
    with _call(base, "/embed", {"sequences": seqs, "side": side}) as r:
        return np.asarray(json.loads(r.read())["embeddings"], np.float32)


@pytest.mark.parametrize("side", ["pep", "rec"])
def test_embed_matches_jax(served, model_files, side):
    seqs = _seqs(np.random.default_rng(1), 5) + ["MK<mask>TAYIAKQR"]
    got = _embed(served, seqs, side)
    want = _jax_embed(model_files, seqs, side, batch_size=8)
    assert got.shape == (6, 128)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_index_written_by_embed_cli_matches_jax(served, model_files):
    with np.load(model_files["dir"] / "index.npz") as index:
        ids, emb = list(index["ids"]), index["embeddings"]
    assert ids == [f"c{i}" for i in range(24)]
    np.testing.assert_allclose(emb, _jax_embed(model_files, model_files["corpus"], "rec"),
                               atol=ATOL)


def test_binary_wire_matches_json(served):
    seqs = _seqs(np.random.default_rng(2), 3)
    ref = _embed(served, seqs, "rec")
    with _call(served, "/embed", {"sequences": seqs, "side": "rec"},
               {"Accept": "application/octet-stream"}) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        assert r.headers["X-Dtype"] == "<f4"
        shape = tuple(int(x) for x in r.headers["X-Shape"].split(","))
        body = r.read()
    assert shape == ref.shape
    np.testing.assert_array_equal(np.frombuffer(body, "<f4").reshape(shape), ref)


def test_topk_order(served, model_files):
    queries = _seqs(np.random.default_rng(3), 2)
    with _call(served, "/topk", {"queries": queries, "side": "pep", "k": 5}) as r:
        hits = json.loads(r.read())["hits"]
    qemb = _jax_embed(model_files, queries, "pep")
    with np.load(model_files["dir"] / "index.npz") as index:
        scores = qemb @ index["embeddings"].T
    for q, row in enumerate(hits):
        assert [h["rank"] for h in row] == [1, 2, 3, 4, 5]
        assert [h["id"] for h in row] == [f"c{i}" for i in np.argsort(-scores[q])[:5]]
        np.testing.assert_allclose([h["score"] for h in row],
                                   np.sort(scores[q])[::-1][:5], atol=ATOL)


def test_healthz_and_errors_stay_json(served):
    with _call(served, "/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["index_size"] == 24
    assert health["device"] == "cpu"
    with pytest.raises(urllib.error.HTTPError) as exc:
        _call(served, "/embed", {"sequences": ["AAAA"], "side": "nope"})
    assert exc.value.code == 400 and "side" in json.loads(exc.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        _call(served, "/embed", {"sequences": [], "side": "pep"})
    assert exc.value.code == 400


def test_coalescer_under_concurrency(served):
    n_threads, n_reqs = 8, 4
    for _ in range(3):
        with _call(served, "/metrics") as r:
            before = json.loads(r.read())
        barrier = threading.Barrier(n_threads)
        errors = []

        def client(i):
            crng = np.random.default_rng(100 + i)
            try:
                barrier.wait(timeout=60)
                for _ in range(n_reqs):
                    assert _embed(served, _seqs(crng, 1), "pep").shape == (1, 128)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors[0]
        assert not any(t.is_alive() for t in threads)
        with _call(served, "/metrics") as r:
            after = json.loads(r.read())
        assert after["requests"] - before["requests"] == n_threads * n_reqs
        assert after["sequences"] - before["sequences"] == n_threads * n_reqs
        if after["device_batches"] - before["device_batches"] < n_threads * n_reqs:
            return
    pytest.fail("no cross-request batching in 3 bursts")


def test_combined_checkpoint_serves_its_own_backbone(tmp_path, model_files):
    """A finetune checkpoint {heads, esm} written by the JAX package."""
    from protein_clip_tpu_torch.cli import embed

    jax_export_npz(tmp_path / "ft.npz", {"heads": model_files["heads"],
                                         "esm": model_files["esm"]})
    args = embed.build_argparser().parse_args(
        TINY + ["--checkpoint", str(tmp_path / "ft.npz"), "--fasta", "x", "--out", "y"])
    mcfg, params, esm_params, device = embed.load_model(args)  # random init replaced
    seqs = _seqs(np.random.default_rng(5), 3)
    from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
    got = embed.embed_sequences(params, esm_params, seqs, "pep", mcfg, EsmTokenizer(), device)
    np.testing.assert_allclose(got, _jax_embed(model_files, seqs, "pep"), atol=ATOL)


@pytest.mark.parametrize("extra,match", [
    (["--device", "cuda"], "CUDA is not available"),
    (["--esm-weights", "some_hf_dir"], "HF"),
])
def test_unported_or_unavailable_options_raise(model_files, extra, match):
    from protein_clip_tpu_torch.cli import serve

    argv = TINY + ["--checkpoint", str(model_files["dir"] / "best_model.npz"), "--port", "0"]
    args = serve.build_argparser().parse_args(argv + extra)
    if "--device" in extra:
        import torch
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
    with pytest.raises((RuntimeError, NotImplementedError), match=match):
        serve.make_server(args)


def _library_entry_points(tmp_path):
    """Each library entry point that places parameters, called without a
    device."""
    import torch

    from protein_clip_tpu_torch.models import clip, esm2, heads
    from protein_clip_tpu_torch.train import checkpoint

    cfg = esm2.ESM2Config.tiny()
    np.savez(tmp_path / "a.npz", a=np.zeros(2, np.float32))
    return {
        "esm2.init_params": lambda: esm2.init_params(cfg, torch.Generator()),
        "clip.init_params": lambda: clip.init_params(clip.CLIPConfig(input_dim=64),
                                                     torch.Generator()),
        "heads.init_head": lambda: heads.init_head(torch.Generator(), 64, 32, 2, 2),
        "heads.init_ffn": lambda: heads.init_ffn(torch.Generator(), 32, 2),
        "checkpoint.from_numpy_tree": lambda: checkpoint.from_numpy_tree(
            {"a": np.zeros(2, np.float32)}),
        "checkpoint.load_npz": lambda: checkpoint.load_npz(
            tmp_path / "a.npz", {"a": torch.zeros(2, device="meta")}),
    }


@pytest.mark.parametrize("entry", ["esm2.init_params", "clip.init_params", "heads.init_head",
                                   "heads.init_ffn", "checkpoint.from_numpy_tree",
                                   "checkpoint.load_npz"])
def test_library_entry_points_default_to_cuda(tmp_path, entry):
    """Without device= the library places parameters on cuda, so on a host
    without CUDA it raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _library_entry_points(tmp_path)[entry]()


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", ["t6_8M", "t12_35M", "t30_150M", "t33_650M", "t36_3B",
                                    "t48_15B", "tiny"])
def test_esm_config_keeps_the_kernel_and_refuses_what_it_does_not_take(family, dtype_name):
    """esm_config never swaps in the eager attention: every family keeps
    attention_impl='fused', and the kernel's config check (which load_esm
    and esm2.forward run on CUDA) passes bf16 at head_dim 32 only."""
    from protein_clip_tpu_torch.cli import common
    from protein_clip_tpu_torch.ops import attention

    cfg = common.esm_config(family, dtype_name)
    assert cfg.attention_impl == "fused"
    if family == "t30_150M" and dtype_name == "bfloat16":
        attention.check_config(cfg.compute_dtype, cfg.head_dim)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            attention.check_config(cfg.compute_dtype, cfg.head_dim)


def test_lora_checkpoint_raises(tmp_path, model_files):
    """A LoRA run's {heads, lora} npz (written by the JAX package) loads for
    serving: the heads as saved, and the adapters merged into the base
    backbone as the JAX loader merges them, within 1e-6 (float32, the same
    einsum in another order). Adapters without heads raise."""
    from protein_clip_tpu.train import lora as jlora
    from protein_clip_tpu_torch.cli import common
    from protein_clip_tpu_torch.models import clip
    from protein_clip_tpu_torch.train import checkpoint

    np.savez(tmp_path / "bare.npz", **{"lora/attn/q/a": np.zeros((2, 64, 1), np.float32),
                                       "lora/attn/q/b": np.zeros((2, 1, 64), np.float32)})
    esm_cfg = common.esm_config("tiny", "float32")
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    esm = checkpoint.from_numpy_tree(jax.tree.map(np.asarray, model_files["esm"]), "cpu")
    with pytest.raises(KeyError, match="missing"):
        common.load_clip_checkpoint(tmp_path / "bare.npz", mcfg, esm, "cpu")

    targets = jlora.ATTN_TARGETS + jlora.FFN_TARGETS
    adapters = jax.tree.map(lambda a: a + 0.05, jlora.init_lora(
        jax.random.key(5), model_files["esm"], 4, targets))
    jax_export_npz(tmp_path / "lora.npz", jlora.init_params(adapters, model_files["heads"]))
    heads, merged = common.load_clip_checkpoint(tmp_path / "lora.npz", mcfg, esm, "cpu")
    jheads, jmerged = jcommon.load_clip_checkpoint(tmp_path / "lora.npz", model_files["mcfg"],
                                                   model_files["esm"])
    for got, want in ((heads, jheads), (merged, jmerged)):
        flat, jflat = checkpoint._flatten(got), checkpoint._flatten(jax.tree.map(np.asarray, want))
        assert flat.keys() == jflat.keys()
        for key in flat:
            np.testing.assert_allclose(flat[key].numpy(), jflat[key], atol=1e-6, err_msg=key)
    moved = merged["layers"]["ffn"]["wi"]["w"] - esm["layers"]["ffn"]["wi"]["w"]
    assert float(moved.abs().max()) > 0


BLOCKER = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "protein_clip_tpu", "transformers", "orbax", "matplotlib")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
sys.meta_path.insert(0, Block())
import protein_clip_tpu_torch
names = [m.name for m in pkgutil.walk_packages(protein_clip_tpu_torch.__path__,
                                               "protein_clip_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    """Every port module and chip_smoke.py import with jax and the JAX
    package (and transformers, orbax, matplotlib) blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 18
    for mod in ("train.filip_engine", "cli.main_2protein_filip"):
        assert f"protein_clip_tpu_torch.{mod}" in names


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernels_line_holds_no_computed_time():
    """chip_smoke.py's kernels line keeps what the run measured and bound_ms:
    the ceilings and floors the timing rows work out stay off it, at every
    depth."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    row = {"ms": 1.0, "bound_ms": 0.5, "cuda_core_ceiling_ms": 2.0, "launch_floor_ms": 0.1,
           "exp_floor_ms": 0.3, "at_4096": {"ms": 3.0, "cuda_core_ceiling_ms": 4.0},
           "dense": [{"ms": 5.0, "exp_floor_ms": 0.2}], "topk": {"ffma_ceiling_ms": 0.06}}
    assert chip_smoke.measured_only([row]) == [
        {"ms": 1.0, "bound_ms": 0.5, "at_4096": {"ms": 3.0}, "dense": [{"ms": 5.0}], "topk": {}}]
