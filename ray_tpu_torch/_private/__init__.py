"""The port's runtime internals (counterpart of ``ray_tpu/_private``): the
distributed core (ids, config, wire, serialization, task specs, the object
store client, RPC, scheduler, GCS, raylet, worker, node bootstrap,
runtime environments), ``event_stats`` and the ``chaos`` fault-injection
harness."""
