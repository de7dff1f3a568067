"""Utilities of the port (counterpart of ``ray_tpu/util``): the metrics
registry (``metrics``), tracing spans (``tracing``) and the scheduling
strategies of the core (``scheduling_strategies``)."""
