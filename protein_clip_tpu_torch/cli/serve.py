"""Online serving: JSON-over-HTTP embeddings + top-k retrieval.

    python -m protein_clip_tpu_torch.cli.serve --checkpoint best_model.npz \\
        --index index.npz --port 8080 [--filip] [--device cpu]

Loads a trained checkpoint once, keeps the backbone on the device, and
answers requests from memory. On CUDA every attention layer runs the
hand-written kernel (``ops/attention.py``), and FILIP's /topk the max-sim
kernel (``ops/filip.py``).

API (all JSON):
  GET  /healthz  -> {"status": "ok", "model": ..., "index_size": N}
  GET  /metrics  -> serving counters: requests, sequences, device_batches,
                    mean_requests_per_batch (the coalescer's effectiveness),
                    encode EMA
  POST /embed    {"sequences": [...], "side": "pep"|"rec"}
                 -> {"embeddings": [[...], ...]}
                 With ``Accept: application/octet-stream`` the body is raw
                 little-endian float32 (row-major), headers ``X-Shape: N,D``
                 and ``X-Dtype: <f4``.
  POST /topk     {"queries": [...], "side": "pep", "k": 10}
                 -> {"hits": [[{"id", "score", "rank"}, ...], ...]}

With ``--filip`` (a FILIP checkpoint and an ``embed --filip`` token index)
/embed returns token-level embeddings: JSON {"tokens", "lengths"}, or the
binary body (X-Shape N,T,D) after an int32 prefix of the per-row true
lengths declared by X-Prefix-Len and X-Prefix-Dtype (pads are a row
suffix). /topk ranks by direction-averaged late-interaction max-sim through
the masked max-sim kernel (``ops/filip.py``).

Requests batch two ways: within a request through ``embed_sequences``
(length-sorted bucket batches, pow2-padded row counts), and ACROSS
concurrent requests through an adaptive coalescer: one worker thread owns
the device, drains everything queued while the previous encode ran and
encodes it as one batch per side. When the previous cycle already showed
concurrency it waits a short collection window (a quarter of the measured
encode time, at most 5 ms) for the cohort of closed-loop clients to
re-form; a request arriving at a quiet server dispatches at once.
Finetuned (combined {heads, esm}) checkpoints are served with their own
backbone.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .embed import embed_sequences, embed_sequences_tokens, filip_config, load_model
from . import common
from ..eval.embed import nearest_partners
from ..eval.retrieval import filip_score_matrix, filip_score_matrix_ragged
from ..utils import prng


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--checkpoint", required=True, help="best_model.npz from a training run")
    p.add_argument("--index", default=None,
                   help="npz from cli.embed ({ids, embeddings}; with --filip a ragged "
                        "token-level {ids, tokens, lengths} from `embed --filip`); "
                        "enables /topk")
    p.add_argument("--filip", action="store_true",
                   help="serve a FILIP checkpoint: /embed returns token-level "
                        "embeddings, /topk ranks by late-interaction max-sim")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks an ephemeral port (printed on startup)")
    return p


class _Work:
    """One request's slice of a coalesced encode."""

    __slots__ = ("seqs", "side", "event", "result", "error")

    def __init__(self, seqs: list[str], side: str):
        self.seqs = seqs
        self.side = side
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class ClipService:
    """Checkpoint + optional index, shared across requests."""

    def __init__(self, args):
        self.mcfg, self.params, self.esm_params, self.device = load_model(args)
        self.filip = bool(args.filip)
        self.fcfg = filip_config(self.mcfg) if self.filip else None
        self.tokenizer = common.make_tokenizer()
        self.model_name = args.esm_config
        self.batch_size = args.batch_size
        self.corpus_ids: list[str] = []
        self.corpus = None
        self.corpus_tokens = self.corpus_lengths = self.corpus_mask = None
        if args.index:
            with np.load(args.index, allow_pickle=False) as index:
                self.corpus_ids = [str(i) for i in index["ids"]]
                if self.filip:
                    self.corpus_tokens, self.corpus_lengths, self.corpus_mask = (
                        common.read_token_index(index, self.mcfg.embedding_dim))
                else:
                    self.corpus = np.asarray(index["embeddings"], np.float32)
                    if self.corpus.shape[1] != self.mcfg.embedding_dim:
                        raise ValueError(f"index embedding dim {self.corpus.shape[1]} != "
                                         f"model --embedding-dim {self.mcfg.embedding_dim}")
        self._queue: queue.SimpleQueue[_Work] = queue.SimpleQueue()
        self._last_nreq = 1
        self._encode_ema_s = 0.0
        # counters, written by the worker thread only; /metrics reads them
        # racily, which is fine for monotonic counts
        self._n_batches = 0
        self._n_requests = 0
        self._n_seqs = 0
        self._t_start = time.time()
        self._worker = threading.Thread(target=self._encode_loop, daemon=True)
        self._worker.start()

    def embed(self, sequences: list[str], side: str):
        """Pooled (N, D) embeddings, or with --filip (tokens (N, T, D), mask
        (N, T) int8)."""
        if side not in ("pep", "rec"):
            raise ValueError(f"side must be 'pep' or 'rec', got {side!r}")
        work = _Work(sequences, side)
        self._queue.put(work)
        work.event.wait()
        if work.error is not None:
            raise work.error
        return work.result

    def _encode_loop(self) -> None:
        while True:
            batch = [self._queue.get()]
            deadline = None
            if self._last_nreq > 1:
                deadline = time.perf_counter() + min(0.005, 0.25 * self._encode_ema_s)
            while True:  # drain everything that arrived meanwhile
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    if deadline is None or time.perf_counter() >= deadline:
                        break
                    time.sleep(0.0002)
            self._last_nreq = len(batch)
            t_encode = time.perf_counter()
            by_side: dict[str, list[_Work]] = {}
            for w in batch:
                by_side.setdefault(w.side, []).append(w)
            for side, works in by_side.items():
                try:
                    flat = [s for w in works for s in w.seqs]
                    if self.filip:
                        toks, mask = embed_sequences_tokens(
                            self.params, self.esm_params, flat, side, self.fcfg,
                            self.tokenizer, self.device, batch_size=self.batch_size,
                            pad_batch=True)
                    else:
                        emb = embed_sequences(self.params, self.esm_params, flat, side,
                                              self.mcfg, self.tokenizer, self.device,
                                              batch_size=self.batch_size, pad_batch=True)
                    off = 0
                    for w in works:
                        rows = slice(off, off + len(w.seqs))
                        w.result = (toks[rows], mask[rows]) if self.filip else emb[rows]
                        off += len(w.seqs)
                except Exception as e:  # noqa: BLE001 — fail the group,
                    for w in works:    # keep the worker alive
                        w.error = e
                finally:
                    for w in works:
                        w.event.set()
            dt = time.perf_counter() - t_encode
            self._encode_ema_s = (dt if self._encode_ema_s == 0.0
                                  else 0.8 * self._encode_ema_s + 0.2 * dt)
            self._n_batches += 1
            self._n_requests += len(batch)
            self._n_seqs += sum(len(w.seqs) for w in batch)

    def metrics(self) -> dict:
        """Serving counters: how well is the coalescer doing its job?"""
        nb = self._n_batches
        return {
            "uptime_s": round(time.time() - self._t_start, 1),
            "requests": self._n_requests,
            "sequences": self._n_seqs,
            "device_batches": nb,
            "mean_requests_per_batch": round(self._n_requests / nb, 2) if nb else None,
            "encode_ema_ms": round(1e3 * self._encode_ema_s, 2),
            "index_size": len(self.corpus_ids),
        }

    def topk(self, queries: list[str], side: str, k: int):
        if not self.corpus_ids:
            raise ValueError("no --index loaded; /topk unavailable")
        k = max(1, min(k, len(self.corpus_ids)))
        if self.filip:
            q_t, q_m = self.embed(queries, side)
            if self.corpus_lengths is not None:  # ragged index
                sim = filip_score_matrix_ragged(q_t, q_m, self.corpus_tokens,
                                                self.corpus_lengths,
                                                self.params["temperature"], device=self.device)
            else:  # legacy dense {tokens, mask} index
                sim = filip_score_matrix(q_t, q_m, self.corpus_tokens, self.corpus_mask,
                                         self.params["temperature"], device=self.device)
            idx = np.argsort(-sim, axis=1)[:, :k]
            scores = np.take_along_axis(sim, idx, axis=1)
        else:
            idx, scores = nearest_partners(self.embed(queries, side), self.corpus, k=k)
        return [[{"id": self.corpus_ids[idx[q, r]], "score": float(scores[q, r]),
                  "rank": r + 1} for r in range(k)]
                for q in range(len(queries))]


def make_handler(service: ClipService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keeps connections open (every response has a
        # Content-Length), so a closed-loop client's next request lands in
        # the coalescer's window instead of behind a TCP connect
        protocol_version = "HTTP/1.1"
        timeout = 60  # an idle connection releases its thread after 60 s
        # headers and body leave in two writes; without TCP_NODELAY Nagle
        # holds the second for the peer's delayed ACK on a kept-alive socket
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _binary(self, arr: np.ndarray, prefix: np.ndarray | None = None) -> None:
            """Raw little-endian float32 body; the shape rides the headers.

            ``prefix``: an int32 vector (FILIP's per-row lengths) sent as a
            ``<i4`` section before the floats and declared by X-Prefix-Len
            and X-Prefix-Dtype; a header line would cap it at 64 KiB."""
            body = np.ascontiguousarray(arr, dtype="<f4").tobytes()
            pre = b"" if prefix is None else np.ascontiguousarray(prefix, "<i4").tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Shape", ",".join(map(str, arr.shape)))
            self.send_header("X-Dtype", "<f4")
            if prefix is not None:
                self.send_header("X-Prefix-Len", str(int(prefix.size)))
                self.send_header("X-Prefix-Dtype", "<i4")
            self.send_header("Content-Length", str(len(pre) + len(body)))
            self.end_headers()
            if pre:
                self.wfile.write(pre)
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                return self._json(200, service.metrics())
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            return self._json(200, {
                "status": "ok", "model": service.model_name,
                "embedding_dim": service.mcfg.embedding_dim,
                "index_size": len(service.corpus_ids),
                "filip": service.filip,
                "device": str(service.device),
            })

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                seq_key = "queries" if self.path == "/topk" else "sequences"
                seqs = req.get(seq_key)
                if (not isinstance(seqs, list) or not seqs
                        or not all(isinstance(s, str) and s for s in seqs)):
                    return self._json(400, {"error": f"'{seq_key}' must be a non-empty "
                                                     f"list of non-empty strings"})
                side = req.get("side", "pep")
                if self.path == "/embed":
                    binary = "application/octet-stream" in (self.headers.get("Accept") or "")
                    if service.filip:
                        toks, mask = service.embed(seqs, side)
                        # pads are a row suffix, so the true lengths give the mask
                        lengths = mask.astype(np.int32).sum(axis=1)
                        if binary:
                            return self._binary(toks, prefix=lengths)
                        return self._json(200, {"tokens": toks.tolist(),
                                                "lengths": [int(n) for n in lengths]})
                    emb = service.embed(seqs, side)
                    if binary:
                        return self._binary(emb)
                    return self._json(200, {"embeddings": emb.tolist()})
                if self.path == "/topk":
                    hits = service.topk(seqs, side, int(req.get("k", 10)))
                    return self._json(200, {"hits": hits})
                return self._json(404, {"error": "unknown path"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep the server alive
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 resets a burst of concurrent clients
    # at the accept queue before the coalescer ever sees them
    request_queue_size = 128


def make_server(args) -> ThreadingHTTPServer:
    """Bound (not yet serving) HTTP server — split out for tests."""
    service = ClipService(args)
    return _Server((args.host, args.port), make_handler(service))


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    prng.set_seed(args.seed)
    server = make_server(args)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(/healthz, /embed, /topk{'' if args.index else ' [no index]'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
