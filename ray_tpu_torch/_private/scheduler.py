"""Cluster scheduling policies: node selection and bundle placement.

Equivalent of the reference's scheduling policy layer
(reference: src/ray/raylet/scheduling/policy/ — hybrid top-k
(hybrid_scheduling_policy.h:50), spread, node-affinity, and the bundle
policies PACK/SPREAD/STRICT_PACK/STRICT_SPREAD
(bundle_scheduling_policy.cc)). The port's copy of
``ray_tpu/_private/scheduler.py`` without its ici-domain slice-affinity
term, which models a TPU pod slice and has no counterpart on one GPU host.
"""
from __future__ import annotations

import ctypes
import os
import random
import threading
from typing import Sequence

_CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cpp")
_native_lock = threading.Lock()
_native_lib: ctypes.CDLL | bool | None = None  # None=untried, False=unavailable


def _load_native():
    """Build (cached) + load the C++ scheduling core
    (cpp/sched.cpp — the native analog of hybrid_scheduling_policy.h:50)."""
    global _native_lib
    with _native_lock:
        if _native_lib is not None:
            return _native_lib or None
        src = os.path.join(_CPP_DIR, "sched.cpp")
        try:
            from ray_tpu_torch._private.native_build import build_native

            # content-hash gate: a stale committed/restored binary can never
            # be loaded — the artifact path embeds the source digest
            out = build_native(src, "libray_tpu_torch_sched.so",
                               ["-O2", "-shared", "-fPIC"])
            lib = ctypes.CDLL(out)
            lib.rt_pick_node.restype = ctypes.c_int
            lib.rt_pick_node.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            _native_lib = lib
        except Exception as e:  # noqa: BLE001 — no compiler / load failure
            import sys

            print(
                f"[ray_tpu_torch] native scheduler unavailable ({e!r}); "
                "using the Python policy",
                file=sys.stderr,
            )
            _native_lib = False
        return _native_lib or None


def _pick_node_native(
    resources: dict[str, float],
    nodes: dict[bytes, dict],
    strategy: str,
    local_node_id: bytes | None,
) -> bytes | None:
    lib = _load_native()
    if lib is None:
        return _SENTINEL
    cols = sorted(set(resources) | {"CPU"})
    cpu_col = cols.index("CPU")
    ids = list(nodes)
    if strategy == "spread":
        # the C++ core takes the first node on ties; shuffling the row
        # order restores the Python policy's uniform tie-breaking so
        # spread bursts don't pile onto one node between heartbeats
        random.shuffle(ids)
    n, r = len(ids), len(cols)
    demand = (ctypes.c_double * r)(*[resources.get(c, 0.0) for c in cols])
    avail = (ctypes.c_double * (n * r))()
    total = (ctypes.c_double * (n * r))()
    alive = (ctypes.c_uint8 * n)()
    for i, nid in enumerate(ids):
        node = nodes[nid]
        av = node.get("available", node["resources"])
        tot = node["resources"]
        for j, c in enumerate(cols):
            avail[i * r + j] = av.get(c, 0.0)
            total[i * r + j] = tot.get(c, 0.0)
        alive[i] = 1 if node.get("alive", True) else 0
    local_index = ids.index(local_node_id) if local_node_id in nodes else -1
    idx = lib.rt_pick_node(
        demand, r, avail, total, alive, n, cpu_col,
        1 if strategy == "spread" else 0, local_index,
    )
    return None if idx < 0 else ids[idx]


_SENTINEL = object()  # native path unavailable marker


def fits(resources: dict[str, float], available: dict[str, float]) -> bool:
    return all(available.get(k, 0.0) + 1e-9 >= v for k, v in resources.items())


def subtract(available: dict[str, float], resources: dict[str, float]) -> None:
    for k, v in resources.items():
        available[k] = available.get(k, 0.0) - v


def add(available: dict[str, float], resources: dict[str, float]) -> None:
    for k, v in resources.items():
        available[k] = available.get(k, 0.0) + v


def pick_node(
    resources: dict[str, float],
    nodes: dict[bytes, dict],
    *,
    strategy: str = "default",
    local_node_id: bytes | None = None,
    affinity_node_id: bytes | None = None,
    soft: bool = False,
) -> bytes | None:
    """Pick a node for one task. ``nodes[nid]['available']`` must be present.

    default (hybrid): local node first if it fits, else the *most* loaded
    feasible remote node (pack; reference hybrid policy packs up to a
    threshold before spreading). spread: least-loaded feasible node.
    """
    if strategy in ("default", "spread"):
        # hot path: dense-matrix selection in the C++ core; Python below is
        # the fallback AND the semantics oracle (tests assert equivalence)
        picked = _pick_node_native(resources, nodes, strategy, local_node_id)
        if picked is not _SENTINEL:
            return picked
    feasible = [
        nid
        for nid, n in nodes.items()
        if n.get("alive", True) and fits(resources, n.get("available", n["resources"]))
    ]
    if strategy == "node_affinity":
        if affinity_node_id in feasible:
            return affinity_node_id
        if not soft:
            return None
        # soft affinity falls through to default choice
    if not feasible:
        return None
    if strategy == "spread":
        return max(
            feasible,
            key=lambda nid: _avail_frac(nodes[nid]) + random.random() * 1e-6,
        )
    # default/hybrid
    if local_node_id in feasible:
        return local_node_id
    return min(feasible, key=lambda nid: _avail_frac(nodes[nid]))


def _avail_frac(node: dict) -> float:
    total = node["resources"]
    avail = node.get("available", total)
    cpu_total = total.get("CPU", 1.0) or 1.0
    return avail.get("CPU", 0.0) / cpu_total


def schedule_bundles(
    bundles: Sequence[dict[str, float]],
    strategy: str,
    nodes: dict[bytes, dict],
) -> list[bytes] | None:
    """Map each bundle to a node id, or None if infeasible.

    Reference: bundle_scheduling_policy.cc — PACK (best effort co-locate),
    SPREAD (best effort spread), STRICT_PACK (all on one node),
    STRICT_SPREAD (all on distinct nodes).
    """
    avail = {
        nid: dict(n.get("available", n["resources"]))
        for nid, n in nodes.items()
        if n.get("alive", True)
    }
    if not avail:
        return None

    if strategy == "STRICT_PACK":
        for nid in sorted(avail, key=lambda n: -sum(avail[n].values())):
            trial = dict(avail[nid])
            if all(_try_place(b, trial) for b in bundles):
                return [nid] * len(bundles)
        return None

    if strategy == "STRICT_SPREAD":
        placement: list[bytes] = []
        used: set[bytes] = set()
        for b in bundles:
            cands = [nid for nid in avail if nid not in used and fits(b, avail[nid])]
            if not cands:
                return None
            nid = cands[0]
            subtract(avail[nid], b)
            placement.append(nid)
            used.add(nid)
        return placement

    # PACK / SPREAD (best-effort)
    placement = []
    order = (
        sorted(avail, key=lambda n: -sum(avail[n].values()))
        if strategy == "PACK"
        else sorted(avail, key=lambda n: sum(avail[n].values()))
    )
    for b in bundles:
        chosen = None
        cands = [nid for nid in order if fits(b, avail[nid])]
        if strategy == "PACK":
            # prefer nodes already hosting earlier bundles of this group
            hosting = [c for c in cands if c in placement]
            chosen = (hosting or cands or [None])[0]
        else:
            not_hosting = [c for c in cands if c not in placement]
            chosen = (not_hosting or cands or [None])[0]
        if chosen is None:
            return None
        subtract(avail[chosen], b)
        placement.append(chosen)
    return placement


def _try_place(bundle: dict[str, float], avail: dict[str, float]) -> bool:
    if fits(bundle, avail):
        subtract(avail, bundle)
        return True
    return False
