"""Process-local support of the port (counterpart of ``ray_tpu/_private``):
``event_stats`` and the ``chaos`` fault-injection harness."""
