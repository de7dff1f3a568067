"""Tuner: the user-facing experiment entry point (the port's copy of
``ray_tpu/tune/tuner.py``; ``TuneResult.checkpoint`` is the port's Train
``Checkpoint``, and the two dataframe views import pandas when called,
raising an ``ImportError`` that names it where it is missing).

Equivalent of the reference's Tuner/ResultGrid (reference: python/ray/tune/
tuner.py:59 Tuner, tune.py:293 tune.run, result_grid.py ResultGrid).
``Tuner.restore(path, trainable)`` resumes an interrupted experiment from
its persisted state (reference: tune/execution/experiment_state.py).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trial import ERROR, TERMINATED, Trial
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    search_alg: Searcher | None = None
    scheduler: TrialScheduler | None = None
    seed: int | None = None


@dataclass
class TuneRunConfig:
    name: str = ""
    storage_path: str = "~/ray_tpu_torch_results"
    max_failures: int = 0


def _pandas(view: str):
    try:
        import pandas
    except ImportError as e:
        raise ImportError(f"{view} needs pandas, which is not installed") \
            from e
    return pandas


class TuneResult:
    def __init__(self, trial: Trial, metric: str, mode: str):
        self.trial = trial
        self.config = trial.config
        self.metrics = trial.last_result or {}
        self.error = trial.error
        self.checkpoint = None
        if trial.checkpoint_path:
            from ray_tpu_torch.train.checkpoint import Checkpoint

            self.checkpoint = Checkpoint(trial.checkpoint_path)
        self._metric, self._mode = metric, mode

    @property
    def metrics_dataframe(self):
        return _pandas("metrics_dataframe").DataFrame(self.trial.results)


class ResultGrid:
    def __init__(self, trials: list[Trial], metric: str, mode: str):
        self._trials = trials
        self._metric, self._mode = metric, mode
        self._results = [TuneResult(t, metric, mode) for t in trials]

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> TuneResult:
        return self._results[i]

    @property
    def errors(self) -> list[str]:
        return [t.error for t in self._trials if t.status == ERROR]

    def get_best_result(self, metric: str | None = None,
                        mode: str | None = None) -> TuneResult:
        metric = metric or self._metric
        mode = mode or self._mode
        done = [r for r in self._results
                if r.metrics and metric in r.metrics]
        if not done:
            raise RuntimeError("no completed trials with metric " + metric)
        key = lambda r: r.metrics[metric]
        return max(done, key=key) if mode == "max" else min(done, key=key)

    def get_dataframe(self):
        return _pandas("get_dataframe").DataFrame(
            [{**(t.last_result or {}), "trial_id": t.trial_id,
              "status": t.status, **{f"config/{k}": v
                                     for k, v in t.config.items()
                                     if not isinstance(v, dict)}}
             for t in self._trials]
        )


class Tuner:
    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config: TuneRunConfig | None = None,
        _restore_from: str | None = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or TuneRunConfig()
        self._restore_from = _restore_from

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                tune_config: TuneConfig | None = None,
                param_space: dict | None = None) -> "Tuner":
        """Resume an experiment from its persisted state. With `param_space`
        (and the original TuneConfig seed/num_samples) the search continues
        generating the not-yet-materialized samples; without it, only the
        already-created trials are finished."""
        return cls(trainable, tune_config=tune_config, param_space=param_space,
                   _restore_from=path)

    def _experiment_dir(self) -> str:
        if self._restore_from:
            return os.path.expanduser(self._restore_from)
        name = self.run_config.name or f"tune_{int(time.time())}"
        return os.path.join(os.path.expanduser(self.run_config.storage_path), name)

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        searcher = tc.search_alg or BasicVariantGenerator(
            self.param_space, num_samples=tc.num_samples, seed=tc.seed
        )
        searcher.set_search_properties(tc.metric, tc.mode)
        controller = TuneController(
            self.trainable,
            searcher=searcher,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            experiment_dir=self._experiment_dir(),
            max_concurrent_trials=tc.max_concurrent_trials,
            max_failures=self.run_config.max_failures,
        )
        if self._restore_from:
            if not controller.load_state():
                raise FileNotFoundError(
                    f"no experiment state at {self._restore_from}"
                )
            if tc.search_alg is not None:
                # external searchers are stateful/stochastic: re-suggesting
                # for restored trials would pair fresh ask() configs with old
                # trials' results and corrupt the optimizer's history — only
                # finish the already-materialized trials
                controller._searcher_done = True
            elif self.param_space:
                # deterministic searcher (same param_space + seed): fast-forward
                # past the suggestions already materialized as trials, then keep
                # generating the remaining samples
                for t in controller.trials:
                    searcher.suggest(t.trial_id)
            else:
                controller._searcher_done = True
        trials = controller.run()
        return ResultGrid(trials, tc.metric, tc.mode)
