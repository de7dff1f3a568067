"""Utilities of the port (counterpart of ``ray_tpu/util``): the metrics
registry (``metrics``), tracing spans (``tracing``), the scheduling
strategies of the core (``scheduling_strategies``), placement groups
(``placement_group``) and the state API (``state``)."""
