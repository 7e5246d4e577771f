"""The LM's placement on a mesh of ranks: per-rank shards under the
sharding plan, the gathers and gradient reductions between them, and the
ambient mesh the model reads (``parallel.shard``)."""
