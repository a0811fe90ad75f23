"""Data parallelism over ``torch.distributed``: the port of the data axis of
``protein_clip_tpu/parallel`` (one rank a device, the global batch's
embeddings or tokens gathered so the negatives span it, gradients averaged
over the ranks). Tensor and pipeline parallelism are not ported yet."""
