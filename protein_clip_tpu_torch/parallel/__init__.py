"""The (data, model) mesh over ``torch.distributed``: the port of
``protein_clip_tpu/parallel`` (one rank a device; the data axis gathers the
global batch's embeddings or tokens so the negatives span it and averages
the gradients, the model axis shards the backbone the Megatron way).
Pipeline stages are not ported yet."""
