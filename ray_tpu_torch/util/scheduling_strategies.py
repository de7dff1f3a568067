"""Scheduling strategies (reference: python/ray/util/scheduling_strategies.py
— PlacementGroupSchedulingStrategy:15, NodeAffinitySchedulingStrategy:41)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = 0
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: bytes
    soft: bool = False
