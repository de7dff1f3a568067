"""Utilities of the port (counterpart of ``ray_tpu/util``): the metrics
registry (``metrics``) and process-local tracing spans (``tracing``)."""
