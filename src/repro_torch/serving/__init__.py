"""Port of ``repro.serving``: the paged KV cache, the KV offload managers and the engine."""
