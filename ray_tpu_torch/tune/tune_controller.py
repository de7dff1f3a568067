"""TuneController: the experiment event loop over trial actors (the port's
copy of ``ray_tpu/tune/tune_controller.py``).

Equivalent of the reference's TuneController (reference: python/ray/tune/
execution/tune_controller.py:81 — event loop over RayActorManager creating
one actor per trial, draining results, applying scheduler decisions,
persisting experiment state for resume). Trials here are actors running the
user trainable on a background thread; the controller polls their report
buffers, mirroring the Train WorkerGroup pattern.

The accelerator is the one difference from the JAX package: a trial asks
for cards as ``resources_per_trial={"GPU": n}`` (whole cards; the raylet
sets the actor's ``CUDA_VISIBLE_DEVICES``), the concurrency cap counts
``GPU`` as it counts every resource (so on one card, GPU trials run one
at a time), and a ``"TPU"`` key raises instead of being dropped. A trial
that asks for a card the cluster has not got waits for it; it never runs
on the CPU.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import ray_tpu_torch
from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import (
    CONTINUE, PAUSE, STOP, FIFOScheduler, TrialScheduler,
)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trial import (
    ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial,
)


@ray_tpu_torch.remote
class _TrialActor:
    """Runs one trial's trainable on a background thread; poll() drains."""

    def __init__(self, fn_blob: bytes, config: dict, trial_id: str,
                 trial_dir: str, restore_path: str | None, start_iteration: int):
        import threading

        from ray_tpu_torch.tune import session as tune_session

        self._session = tune_session._TuneSession(
            trial_id, trial_dir, restore_path, start_iteration
        )
        tune_session.init_session(self._session)
        fn = ts.loads_function(fn_blob)

        def runner():
            try:
                fn(config)
                self._session.finish()
            except BaseException as e:  # noqa: BLE001
                import traceback

                self._session.finish(
                    f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                )

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def poll(self, since: int) -> dict:
        reports, done, error = self._session.drain(since)
        return {"reports": reports, "done": done, "error": error}


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        *,
        searcher: Searcher,
        scheduler: TrialScheduler | None,
        metric: str,
        mode: str,
        experiment_dir: str,
        max_concurrent_trials: int | None = None,
        resources_per_trial: dict | None = None,
        max_failures: int = 0,
        poll_interval: float = 0.05,
        reports_per_step: int = 8,
    ):
        self.fn_blob = ts.dumps_function(trainable)
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(metric, mode)
        self.metric, self.mode = metric, mode
        self.experiment_dir = experiment_dir
        os.makedirs(experiment_dir, exist_ok=True)
        self.resources_per_trial = resources_per_trial or {"CPU": 1}
        if "TPU" in self.resources_per_trial:
            raise ValueError(
                "resources_per_trial: the port's trials hold cards as 'GPU' "
                "(e.g. {'CPU': 1, 'GPU': 1}), not 'TPU'")
        if max_concurrent_trials is None:
            # fit = min over every requested resource of total/requested, so
            # GPU-bound trials don't oversubscribe cards just because CPUs
            # are plentiful
            total = ray_tpu_torch.cluster_resources()
            fits = [
                int(total.get(r, 0) // amt)
                for r, amt in self.resources_per_trial.items()
                if amt > 0
            ]
            max_concurrent_trials = max(1, min(fits)) if fits else 1
        self.max_concurrent = max_concurrent_trials
        self.max_failures = max_failures
        self.poll_interval = poll_interval
        # fairness cap: drain at most this many reports per trial per step so
        # a fast trial cannot flood the scheduler before its peers report
        # (rung/quantile comparisons need interleaved streams)
        self.reports_per_step = reports_per_step
        self.trials: list[Trial] = []
        self._actors: dict[str, object] = {}
        self._cursors: dict[str, int] = {}
        self._failures: dict[str, int] = {}
        self._searcher_done = False

    # ---- experiment state persistence (reference: tune/execution/
    # experiment_state.py — enables Tuner.restore) ----

    def _state_path(self) -> str:
        return os.path.join(self.experiment_dir, "experiment_state.json")

    def save_state(self) -> None:
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"trials": [t.to_json() for t in self.trials]}, f)
        os.replace(tmp, self._state_path())

    def load_state(self) -> bool:
        if not os.path.exists(self._state_path()):
            return False
        with open(self._state_path()) as f:
            state = json.load(f)
        for d in state["trials"]:
            t = Trial.from_json(d, self.experiment_dir)
            if t.status in (RUNNING, PENDING, PAUSED):
                # resume from last checkpoint if any
                t.status = PENDING
                t.restore_path = t.checkpoint_path
            self.trials.append(t)
            if t.status in (RUNNING, PENDING, PAUSED):
                self.scheduler.on_trial_add(t)
        return True

    # ---- event loop ----

    def _launch(self, trial: Trial) -> None:
        actor = _TrialActor.options(
            num_cpus=self.resources_per_trial.get("CPU", 1),
            num_gpus=self.resources_per_trial.get("GPU", 0),
        ).remote(
            self.fn_blob, trial.config, trial.trial_id, trial.trial_dir,
            trial.restore_path, trial.iteration,
        )
        trial.restore_path = None
        trial.status = RUNNING
        self._actors[trial.trial_id] = actor
        self._cursors[trial.trial_id] = 0

    def _stop_actor(self, trial: Trial) -> None:
        actor = self._actors.pop(trial.trial_id, None)
        self._cursors.pop(trial.trial_id, None)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass

    def _maybe_add_trials(self) -> None:
        import uuid

        while not self._searcher_done:
            n_active = sum(1 for t in self.trials if t.status in (PENDING, RUNNING))
            if n_active >= self.max_concurrent * 2:
                break
            # mint the trial id first so the searcher sees the same id in
            # suggest() and on_trial_complete()
            tid = uuid.uuid4().hex[:8]
            cfg = self.searcher.suggest(tid)
            if cfg is None:
                self._searcher_done = True
                break
            trial = Trial(config=cfg, experiment_dir=self.experiment_dir,
                          trial_id=tid)
            self.trials.append(trial)
            self.scheduler.on_trial_add(trial)

    def step(self) -> bool:
        """One controller iteration; returns False when the experiment is done."""
        self._maybe_add_trials()
        self._apply_pending_actions()
        running = [t for t in self.trials if t.status == RUNNING]
        # launch pending trials up to the concurrency cap
        for t in self.trials:
            if t.status == PENDING and len(running) < self.max_concurrent:
                self._launch(t)
                running.append(t)
        progressed = False
        for trial in list(running):
            actor = self._actors.get(trial.trial_id)
            if actor is None:
                continue
            try:
                out = ray_tpu_torch.get(
                    actor.poll.remote(self._cursors[trial.trial_id]), timeout=30
                )
            except ray_tpu_torch.exceptions.GetTimeoutError:
                # actor may still be queued behind busy resources (cold worker
                # spawn, contended cards) — not dead, just no progress yet
                continue
            except Exception as e:  # actor died
                self._on_trial_error(trial, f"trial actor died: {e}")
                continue
            reports = out["reports"]
            drained_all = len(reports) <= self.reports_per_step
            reports = reports[: self.reports_per_step]
            self._cursors[trial.trial_id] += len(reports)
            for rep in reports:
                progressed = True
                metrics = dict(rep["metrics"])
                trial.iteration = rep["iteration"]
                metrics.setdefault("training_iteration", trial.iteration)
                trial.last_result = metrics
                trial.results.append(metrics)
                if "checkpoint_path" in rep:
                    trial.checkpoint_path = rep["checkpoint_path"]
                decision = self.scheduler.on_trial_result(trial, metrics)
                if decision == STOP:
                    self._stop_actor(trial)
                    trial.status = TERMINATED
                    self.searcher.on_trial_complete(trial.trial_id, metrics)
                    break
                if decision == PAUSE:
                    # park at the checkpoint; the scheduler resumes/stops it
                    # later through pending_actions (synchronous bands)
                    self._stop_actor(trial)
                    trial.restore_path = trial.checkpoint_path
                    trial.status = PAUSED
                    break
                if decision == sched_mod.PopulationBasedTraining.EXPLOIT:
                    # scheduler already rewrote trial.config/restore_path
                    self._stop_actor(trial)
                    trial.status = PENDING
                    break
            if trial.status != RUNNING:
                continue
            if out["done"] and drained_all:
                progressed = True
                self._stop_actor(trial)
                if out["error"]:
                    self._on_trial_error(trial, out["error"])
                else:
                    trial.status = TERMINATED
                    self.scheduler.on_trial_complete(trial)
                    self.searcher.on_trial_complete(
                        trial.trial_id, trial.last_result
                    )
        if progressed:
            self.save_state()
        return any(
            t.status in (PENDING, RUNNING, PAUSED) for t in self.trials
        ) or (not self._searcher_done)

    def _apply_pending_actions(self) -> None:
        """Release trials the scheduler parked with PAUSE (sync HyperBand
        resume/stop verdicts land here, once per step)."""
        actions = self.scheduler.pending_actions()
        if not actions:
            return
        by_id = {t.trial_id: t for t in self.trials}
        for tid, verdict in actions.items():
            trial = by_id.get(tid)
            if trial is None or trial.status not in (PAUSED, RUNNING, PENDING):
                continue
            if verdict == "RESUME":
                if trial.status == PAUSED:
                    trial.status = PENDING
            elif verdict == "STOP":
                self._stop_actor(trial)
                trial.status = TERMINATED
                self.searcher.on_trial_complete(trial.trial_id,
                                                trial.last_result)

    def _on_trial_error(self, trial: Trial, error: str) -> None:
        self._stop_actor(trial)
        n = self._failures.get(trial.trial_id, 0)
        if n < self.max_failures:
            self._failures[trial.trial_id] = n + 1
            trial.restore_path = trial.checkpoint_path
            trial.status = PENDING
        else:
            trial.status = ERROR
            trial.error = error
            self.searcher.on_trial_complete(trial.trial_id, error=True)
            # a failed trial leaves any synchronous band it was part of —
            # otherwise paused peers wait on it forever
            self.scheduler.on_trial_complete(trial)

    def run(self) -> list[Trial]:
        while self.step():
            time.sleep(self.poll_interval)
        self.save_state()
        return self.trials
