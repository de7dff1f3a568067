"""Seeded fault injection (the port's copy of ``ray_tpu/_private/chaos.py``,
with a plan state of its own).

A plan is a list of (hook site, trigger, action) faults; instrumented code
calls ``chaos.fire(point, **context)`` at each site, a no-op unless a plan
is active. The port's engine fires the reference's points:

  ``engine.step``     top of every scheduler iteration
  ``engine.prefill``  before a batched prefill call (context: batch)
  ``engine.decode``   before a batched decode step (context: batch)
  ``llm.preempt``     before a running stream is parked (context:
                      request, priority)
  ``llm.resume_preempted`` after a parked stream is re-admitted
                      (context: request, parked_s)
  ``llm.kv.promote``  before a batched host-to-device promotion landing
                      (context: blocks)
  ``llm.kv.demote``   in ``PagedKVCache``, before an evicted block's (or a
                      parked chain's) capture into the host tier (context:
                      block, or blocks); a failed capture is a lost cache
                      entry, never a correctness event

and Serve fires the reference's points of its layer: ``llm.token`` (after
``LLMDeployment`` yields one chunk; context: index, resumed, tag),
``llm.snapshot``, ``handle.dispatch`` (context: method),
``replica_drain``, ``controller_scale``, ``controller.checkpoint``,
``controller.kill`` and ``controller.recover``.

Plans install in-process (``install``) or through the
``RAY_TPU_CHAOS_PLAN`` environment variable (``FaultPlan.to_json``;
worker processes inherit the environment, so a plan exported before the
cluster starts reaches every replica and the controller). Triggers are counters and exact-match context filters, and
``FaultPlan.seed`` seeds the jittered delays, so a schedule replays
identically.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass

ENV_VAR = "RAY_TPU_CHAOS_PLAN"


class ChaosFault(RuntimeError):
    """Raised by a ``raise`` fault (and, as its subclass, by ``drop``)."""


class ChaosDroppedRPC(ChaosFault, ConnectionError):
    """A ``drop`` fault: the instrumented call never happened."""


@dataclass(frozen=True)
class Fault:
    """Fire ``action`` (kill | raise | delay | drop) at hook site ``point``.

    after  trigger on the Nth matching hit (1-based; 0 = the first).
    when   exact-match filter on the fire() context; None matches all.
    times  most firings (None = unlimited).
    arg    delay seconds (jitter ceiling when times != 1), or a message.
    """

    point: str
    action: str
    after: int = 0
    when: dict | None = None
    times: int | None = 1
    arg: float | str | None = None


@dataclass
class FaultPlan:
    seed: int = 0
    faults: tuple = ()

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [asdict(f) for f in self.faults]}
        )

    @staticmethod
    def from_json(blob: str) -> "FaultPlan":
        raw = json.loads(blob)
        return FaultPlan(
            seed=int(raw.get("seed", 0)),
            faults=tuple(Fault(**f) for f in raw.get("faults", ())),
        )


class _State:
    """The active plan and its per-fault counters."""

    def __init__(self, plan: FaultPlan):
        import numpy as np

        self.plan = plan
        self.hits = [0] * len(plan.faults)    # matching hits
        self.fired = [0] * len(plan.faults)   # firings so far
        self.rng = np.random.default_rng(plan.seed)
        self.lock = threading.Lock()


_installed: _State | None = None
_env_state: _State | None = None
_env_checked = False
_mutex = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Activate ``plan`` in this process (over any plan of the
    environment)."""
    global _installed
    with _mutex:
        _installed = _State(plan)
    return plan


def clear() -> None:
    """Deactivate the in-process plan (a plan of the environment, if any,
    is read again at the next ``fire``)."""
    global _installed, _env_state, _env_checked
    with _mutex:
        _installed = None
        _env_state = None
        _env_checked = False


def _active() -> _State | None:
    global _env_state, _env_checked
    if _installed is not None:
        return _installed
    if not _env_checked:
        with _mutex:
            if not _env_checked:
                blob = os.environ.get(ENV_VAR)
                if blob:
                    try:
                        _env_state = _State(FaultPlan.from_json(blob))
                    except Exception:  # noqa: BLE001 — bad plan = no chaos
                        _env_state = None
                _env_checked = True
    return _installed or _env_state


def fire(point: str, **context) -> None:
    """Hook site: trigger the matching faults of the active plan (an
    attribute read and, once, an environment read when none is)."""
    state = _active()
    if state is None:
        return
    for i, f in enumerate(state.plan.faults):
        if f.point != point:
            continue
        if f.when and any(context.get(k) != v for k, v in f.when.items()):
            continue
        with state.lock:
            state.hits[i] += 1
            if f.after and state.hits[i] < f.after:
                continue
            if f.times is not None and state.fired[i] >= f.times:
                continue
            state.fired[i] += 1
        _act(f, state)


def _act(f: Fault, state: _State) -> None:
    if f.action == "delay":
        base = float(f.arg or 0.1)
        time.sleep(base if f.times == 1 else base * (0.5 + state.rng.random()))
    elif f.action == "raise":
        raise ChaosFault(str(f.arg or f"chaos fault at {f.point}"))
    elif f.action == "drop":
        raise ChaosDroppedRPC(str(f.arg or f"chaos dropped rpc at {f.point}"))
    elif f.action == "kill":
        os._exit(1)
    else:
        raise ValueError(f"unknown chaos action {f.action!r}")
