"""The distribution layer: logical-axis rules that place parameters,
optimizer state, batches and caches on a named ``DeviceMesh`` as DTensors
(:mod:`.sharding`)."""
