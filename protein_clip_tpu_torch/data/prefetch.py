"""Background input pipeline: the port of ``protein_clip_tpu/data/prefetch.py``.

A producer thread runs ``prepare`` (tokenize and pad into CPU tensors)
``depth`` batches ahead of the consumer, pinning the host buffers when the
target is a CUDA device. The copy to the device is issued on the consuming
thread, on its current stream, with ``non_blocking=True``: it queues
behind the work already issued there and needs no cross-stream sync.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import torch


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree)


def to_device(tree, device: torch.device):
    """Every tensor of a dict/tuple tree on ``device`` (non-blocking)."""
    return _map_tensors(tree, lambda t: t.to(device, non_blocking=True))


def prefetch_to_device(host_batches: Iterable, prepare: Callable, device,
                       depth: int = 2) -> Iterator:
    """Yield ``prepare(item)`` for each item on ``device``, with the host
    side running ``depth`` batches ahead on a background thread. An error in
    the producer is re-raised in the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def producer():
        try:
            for item in host_batches:
                batch = prepare(item)
                q.put(_map_tensors(batch, torch.Tensor.pin_memory) if pin else batch)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield to_device(item, device)
