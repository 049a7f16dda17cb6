"""Layers of the transformer family: pure functions on dicts of tensors,
the twins of ``repro.models.layers`` (the ``spec_*`` PartitionSpec
functions have no counterpart in the port)."""
