"""Placement groups: gang reservation of resource bundles (the port's copy
of ``ray_tpu/util/placement_group.py``, over the port's GCS and raylet).

Equivalent of the reference's placement group API
(reference: python/ray/util/placement_group.py:41 PlacementGroup, :146
placement_group(); GCS-side 2-phase reservation in
gcs_placement_group_scheduler.cc:884). A bundle names ``GPU`` in whole
cards (``check_whole_gpus``); a task or actor scheduled into a bundle with
``PlacementGroupSchedulingStrategy`` takes its ``CUDA_VISIBLE_DEVICES``
slot from the node as an unplaced one does. The JAX package's
``slice_bundle`` (an ICI slice) has no counterpart yet: its NVLink-domain
term is ROADMAP A9.

The GCS places a group on its view of the nodes' free resources, which a
raylet's heartbeat refreshes; a group asked for within a heartbeat of the
resources' return (a gang restarting on the card its last attempt held)
is left ``PENDING``. ``ready`` asks for such a group again while it waits,
as the reference's GCS reschedules its pending groups.
"""
from __future__ import annotations

import time
from typing import Sequence

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.task_spec import check_whole_gpus
from ray_tpu_torch._private.worker import global_worker


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self._state = "UNKNOWN"

    def ready(self, timeout: float = 30.0) -> bool:
        worker = global_worker()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            r = worker.gcs.call("get_placement_group", {"pg_id": self.id.binary()})
            pg = r["pg"]
            if pg and pg["state"] == "CREATED":
                self._state = "CREATED"
                return True
            time.sleep(0.05)
            if pg and pg["state"] == "PENDING":
                worker.gcs.call("create_placement_group", {
                    "pg_id": self.id.binary(), "bundles": self.bundles,
                    "strategy": self.strategy})
        return False

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    @property
    def bundle_specs(self) -> list[dict]:
        return self.bundles

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(
    bundles: Sequence[dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid strategy {strategy}")
    worker = global_worker()
    pg_id = PlacementGroupID.of(worker.job_id)
    bundles = [check_whole_gpus(dict(b)) for b in bundles]
    worker.gcs.call(
        "create_placement_group",
        {"pg_id": pg_id.binary(), "bundles": bundles, "strategy": strategy},
    )
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    worker = global_worker()
    worker.gcs.call("remove_placement_group", {"pg_id": pg.id.binary()})
