"""Serving on the tiered paged KV cache: :class:`~.kv_cache.PagedKVCache`
(block tables + free list over a device page store) and
:class:`~.engine.ServeEngine` (continuous batching, paged decode)."""
