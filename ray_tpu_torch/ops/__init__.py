"""Tensor ops of the port: layers, attention, paged KV cache, sampling."""
