"""Trial schedulers: FIFO, ASHA, median-stopping, PBT (the port's copy of
``ray_tpu/tune/schedulers.py``; the same decisions for the same result
streams, and the same ``random.Random`` draws for the same seed).

Equivalent of the reference's scheduler suite (reference: python/ray/tune/
schedulers/ — ASHA async_hyperband.py:19, PBT pbt.py:222, median stopping
median_stopping_rule.py). Schedulers see every reported result and return
CONTINUE/STOP; PBT additionally rewrites config + restore checkpoint on
exploit.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from ray_tpu_torch.tune.trial import Trial

CONTINUE = "CONTINUE"
STOP = "STOP"
# the trial is checkpointed and parked; the scheduler releases it later via
# pending_actions() (synchronous band semantics need trials to WAIT)
PAUSE = "PAUSE"


class TrialScheduler:
    def set_search_properties(self, metric: str, mode: str) -> None:
        self.metric, self.mode = metric, mode

    def _score(self, result: dict) -> float:
        v = float(result[self.metric])
        if math.isnan(v):
            return -math.inf  # diverged trials rank worst in either mode
        return v if self.mode == "max" else -v

    def on_trial_add(self, trial: Trial) -> None:
        """Called when the controller creates the trial — BEFORE its first
        report. Synchronous schedulers need the full population to know
        when a barrier is complete."""

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial) -> None:
        pass

    def pending_actions(self) -> Dict[str, str]:
        """trial_id -> "RESUME" | "STOP" for trials the scheduler parked
        with PAUSE; drained by the controller once per step. Base: none."""
        return {}


class FIFOScheduler(TrialScheduler):
    pass


class _Bracket:
    """One ASHA rung ladder: milestones at grace * rf**k, each rung records
    one score per trial (its score when it first reaches the rung)."""

    def __init__(self, grace_period: float, rf: float, max_t: float):
        # rung milestone -> {trial_id: score at crossing}
        self.rungs: Dict[float, Dict[str, float]] = {}
        m = grace_period
        while m < max_t:
            self.rungs[m] = {}
            m = m * rf

    def on_result(self, trial_id: str, t: float, score: float, rf: float) -> str:
        for milestone in sorted(self.rungs, reverse=True):
            if t < milestone:
                continue
            recorded = self.rungs[milestone]
            # record the score seen when this trial first crosses the rung;
            # all judging uses these crossing scores so every comparison is
            # at the same t (current-report scores are at incomparable t)
            recorded.setdefault(trial_id, score)
            # re-judged on EVERY report while this is the trial's highest
            # rung: a trial that crossed an empty rung gets re-checked once
            # peers arrive, so rung order doesn't decide survival
            if len(recorded) >= 2:
                # cutoff = top 1/rf quantile of per-trial crossing scores;
                # own score is included, so the rung's best can never stop
                vals = sorted(recorded.values(), reverse=True)
                cutoff = vals[max(0, int(len(vals) / rf) - 1)]
                if recorded[trial_id] < cutoff:
                    return STOP
            return CONTINUE
        return CONTINUE


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py:19): rungs at
    grace_period * reduction_factor**k; each trial's score is frozen when it
    first crosses a rung, and while that rung is the trial's highest it is
    re-judged on every report: it stops as soon as its frozen crossing score
    falls out of the top 1/reduction_factor of all scores recorded at the
    rung (so a trial that crossed an empty rung can be stopped later, once
    enough peers arrive). Multiple brackets stagger grace periods (bracket s
    starts at grace * rf**s); trials are assigned round-robin."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: float = 3,
                 max_t: int = 100, brackets: int = 1):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._brackets = [
            _Bracket(grace_period * reduction_factor ** s, reduction_factor, max_t)
            for s in range(max(1, brackets))
        ]
        self._trial_bracket: Dict[str, _Bracket] = {}

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        t = result.get(self.time_attr, trial.iteration)
        if t >= self.max_t:
            return STOP
        bracket = self._trial_bracket.setdefault(
            trial.trial_id,
            self._brackets[len(self._trial_bracket) % len(self._brackets)],
        )
        return bracket.on_result(trial.trial_id, t, self._score(result), self.rf)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score is below the median of the running
    averages of completed results (reference: tune/schedulers/
    median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        scores = self._avgs.setdefault(trial.trial_id, [])
        scores.append(self._score(result))
        t = result.get(self.time_attr, trial.iteration)
        if t < self.grace_period:
            return CONTINUE
        others = [sum(v) / len(v) for k, v in self._avgs.items()
                  if k != trial.trial_id and v]
        if len(others) < self.min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        best = max(scores)
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py:222): every
    perturbation_interval, bottom-quantile trials clone the checkpoint of a
    top-quantile trial (exploit) and perturb its hyperparameters (explore).
    The controller applies the returned decision by restarting the trial
    actor with trial.config / trial.restore_path updated in place."""

    EXPLOIT = "EXPLOIT"  # internal decision: controller restarts the trial

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: int | None = None,
                 policy_log_dir: str | None = None):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = random.Random(seed)
        # exploit decisions append (t, config) per trial here, replayable
        # by PopulationBasedTrainingReplay (reference: pbt.py policy logs)
        self.policy_log_dir = policy_log_dir
        self._last_perturb: Dict[str, float] = {}
        # trial_id -> (score, checkpoint_path, config) at last report
        self._state: Dict[str, tuple] = {}

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        score = self._score(result)
        self._state[trial.trial_id] = (score, trial.checkpoint_path, dict(trial.config))
        t = result.get(self.time_attr, trial.iteration)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE

        ranked = sorted(self._state.items(), key=lambda kv: kv[1][0])
        n = len(ranked)
        if n < 2:
            # no peer has reported yet (e.g. its actor is still spawning):
            # leave the boundary armed instead of consuming it, so the
            # comparison happens as soon as a peer shows up
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        k = max(1, int(n * self.quantile))
        bottom = [tid for tid, _ in ranked[:k]]
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id not in bottom or trial.trial_id in top:
            return CONTINUE
        donor_id = self.rng.choice(top)
        donor_score, donor_ckpt, donor_cfg = self._state[donor_id]
        if donor_ckpt is None:
            return CONTINUE
        trial.config = self._explore(donor_cfg)
        trial.restore_path = donor_ckpt
        self._log_policy(trial.trial_id, t, trial.config)
        return self.EXPLOIT

    def _log_policy(self, trial_id: str, t: float, config: dict) -> None:
        if not self.policy_log_dir:
            return
        import json as _json
        import os as _os

        _os.makedirs(self.policy_log_dir, exist_ok=True)
        path = _os.path.join(self.policy_log_dir,
                             f"pbt_policy_{trial_id}.jsonl")
        with open(path, "a") as f:
            f.write(_json.dumps({"t": t, "config": config}) + "\n")

    def _explore(self, config: dict) -> dict:
        new = dict(config)
        for key, spec in self.mutations.items():
            if key not in new:
                continue
            if callable(spec):
                new[key] = spec()
            elif isinstance(spec, list):
                if self.rng.random() < self.resample_prob or new[key] not in spec:
                    new[key] = self.rng.choice(spec)
                else:
                    i = spec.index(new[key])
                    i = min(len(spec) - 1, max(0, i + self.rng.choice([-1, 1])))
                    new[key] = spec[i]
            elif isinstance(spec, dict) and "lower" in spec:
                lo, hi = spec["lower"], spec["upper"]
                if self.rng.random() < self.resample_prob:
                    new[key] = self.rng.uniform(lo, hi)
                else:
                    new[key] = min(hi, max(lo, new[key] * self.rng.choice([0.8, 1.2])))
        return new


class HyperBandScheduler(TrialScheduler):
    """SYNCHRONOUS HyperBand (reference: tune/schedulers/hyperband.py:42
    HyperBandScheduler — distinct from ASHA: successive-halving cuts happen
    at a barrier). All live trials run to the current band milestone; a
    trial that reaches it early is PAUSED (checkpointed + parked) until
    every peer arrives, then the band keeps the top 1/reduction_factor by
    milestone score, STOPs the rest, and resumes survivors toward the next
    milestone (x reduction_factor). The barrier trades the stragglers'
    wall-clock for exact same-budget comparisons — ASHA's frozen crossing
    scores approximate this without waiting.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: float = 3,
                 max_t: int = 81):
        self.time_attr = time_attr
        self.rf = reduction_factor
        self.max_t = max_t
        self.milestone = float(grace_period)
        self._scores: Dict[str, float] = {}  # tid -> score AT the milestone
        self._live: set[str] = set()
        self._paused: set[str] = set()
        self._actions: Dict[str, str] = {}

    def on_trial_add(self, trial: Trial) -> None:
        # membership registers at trial CREATION so the first reporter
        # can't trigger a solo "barrier" before peers ever report
        self._live.add(trial.trial_id)

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        tid = trial.trial_id
        self._live.add(tid)
        t = result.get(self.time_attr, trial.iteration)
        if t >= self.max_t:
            # fully retire the trial: a stale _scores/_paused entry would
            # let a dead trial occupy a keep slot at the next barrier cut
            self._live.discard(tid)
            self._scores.pop(tid, None)
            self._paused.discard(tid)
            self._maybe_cut()
            return STOP
        if t < self.milestone:
            return CONTINUE
        self._scores.setdefault(tid, self._score(result))
        if self._maybe_cut():
            # the band just cut; this trial's own fate is in _actions
            verdict = self._actions.pop(tid, "RESUME")
            return STOP if verdict == "STOP" else CONTINUE
        if trial.checkpoint_path is None:
            # a pause would restart this trial from scratch (nothing to
            # restore); keep it running — its milestone score is already
            # frozen, so the barrier semantics are preserved
            return CONTINUE
        self._paused.add(tid)
        return PAUSE

    def on_trial_complete(self, trial: Trial) -> None:
        self._live.discard(trial.trial_id)
        self._scores.pop(trial.trial_id, None)
        self._paused.discard(trial.trial_id)
        self._maybe_cut()

    def _maybe_cut(self) -> bool:
        """When every live trial has a recorded score at the current
        milestone, run the successive-halving cut."""
        waiting = self._live - set(self._scores)
        if waiting or not self._scores:
            return False
        ranked = sorted(self._scores.items(), key=lambda kv: -kv[1])
        keep = max(1, int(math.ceil(len(ranked) / self.rf)))
        for i, (tid, _score) in enumerate(ranked):
            verdict = "RESUME" if i < keep else "STOP"
            if tid in self._paused:
                self._paused.discard(tid)
                self._actions[tid] = verdict
            else:
                # the trial that triggered the cut is still running; its
                # verdict is consumed by on_trial_result's return
                self._actions[tid] = verdict
            if verdict == "STOP":
                self._live.discard(tid)
        self._scores.clear()
        self.milestone *= self.rf
        return True

    def pending_actions(self) -> Dict[str, str]:
        out = {tid: v for tid, v in self._actions.items()}
        self._actions.clear()
        return out


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant that feeds every milestone observation to a
    linked TuneBOHB searcher (reference: tune/schedulers/hb_bohb.py
    HyperBandForBOHB). The scheduler side of BOHB is unchanged
    synchronous successive halving; the coupling is that each trial's
    score AT a budget barrier becomes a per-budget training point for the
    searcher's TPE model, so later suggestions are model-based at the
    highest fidelity that has enough evidence."""

    def __init__(self, *args, searcher=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._searcher = searcher

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        tid = trial.trial_id
        t = result.get(self.time_attr, trial.iteration)
        if (self._searcher is not None and t >= self.milestone
                and t < self.max_t and tid not in self._scores):
            # the t >= max_t retire path never records a milestone score,
            # so feeding it here would mislabel a full-budget observation
            # with the current (lower) barrier's budget
            # first report at/after the current barrier: this is the score
            # HyperBand will judge at budget=milestone — tell the model
            self._searcher.on_budget_result(tid, self.milestone, result)
        return super().on_trial_result(trial, result)


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (reference: tune/schedulers/pb2.py —
    PBT whose EXPLORE step replaces random perturbation with a GP-bandit
    suggestion: fit a Gaussian process on (hyperparams -> score
    improvement) observations and pick the UCB-maximizing candidate within
    `hyperparam_bounds`). The GP here is a plain numpy RBF regressor — the
    reference wraps GPy; the population sizes involved (tens of points)
    don't need more.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: dict | None = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 1.0,
                 n_candidates: int = 64,
                 seed: int | None = None):
        super().__init__(
            time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},  # explore is GP-driven, not mutation
            quantile_fraction=quantile_fraction,
            seed=seed,
        )
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds={key: [lo, hi]}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        # observations: (config vector, score delta over one interval)
        self._obs_x: List[List[float]] = []
        self._obs_y: List[float] = []
        self._prev_score: Dict[str, float] = {}

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        # record the improvement observation BEFORE the PBT boundary logic
        score = self._score(result)
        t = result.get(self.time_attr, trial.iteration)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last >= self.interval:
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None:
                self._obs_x.append(self._vec(trial.config))
                self._obs_y.append(score - prev)
            self._prev_score[trial.trial_id] = score
        return super().on_trial_result(trial, result)

    def _vec(self, config: dict) -> List[float]:
        out = []
        for k, (lo, hi) in sorted(self.bounds.items()):
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def _explore(self, config: dict) -> dict:
        import numpy as np

        new = dict(config)
        keys = sorted(self.bounds)
        cand = np.array([
            [self.rng.random() for _ in keys]
            for _ in range(self.n_candidates)
        ])
        if len(self._obs_y) >= 3:
            from ray_tpu_torch.tune._gp import gp_ucb_select

            best = gp_ucb_select(self._obs_x, self._obs_y, cand,
                                 kappa=self.kappa)
        else:
            best = cand[0]  # cold start: random draw inside the bounds
        for k, u in zip(keys, best):
            lo, hi = self.bounds[k]
            new[k] = lo + float(u) * (hi - lo)
        return new


class PopulationBasedTrainingReplay(TrialScheduler):
    """Replay a recorded PBT schedule on a SINGLE trial (reference:
    tune/schedulers/pbt.py:1035 PopulationBasedTrainingReplay): the policy
    log written by PopulationBasedTraining(policy_log_dir=...) lists
    (t, config) switch points; the replay applies each config at its
    recorded time, restoring from the trial's own checkpoint — re-training
    the winning lineage without re-running the population."""

    def __init__(self, policy_log: str):
        import json as _json

        self.schedule: List[tuple] = []
        with open(policy_log) as f:
            for line in f:
                line = line.strip()
                if line:
                    rec = _json.loads(line)
                    self.schedule.append((float(rec["t"]), rec["config"]))
        self.schedule.sort(key=lambda x: x[0])
        self._next = 0

    def on_trial_result(self, trial: Trial, result: dict) -> str:
        t = result.get("training_iteration", trial.iteration)
        if self._next < len(self.schedule) and t >= self.schedule[self._next][0]:
            _t, config = self.schedule[self._next]
            self._next += 1
            trial.config = dict(config)
            trial.restore_path = trial.checkpoint_path  # own lineage
            return PopulationBasedTraining.EXPLOIT
        return CONTINUE


# Public alias matching the reference's preferred name (reference:
# tune/schedulers/__init__.py exports ASHAScheduler = AsyncHyperBandScheduler)
ASHAScheduler = AsyncHyperBandScheduler
