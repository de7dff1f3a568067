"""Search spaces + trial-config generators (the port's copy of
``ray_tpu/tune/search.py``: the same ``random.Random`` streams, so the
same seed gives the same suggestions).

Equivalent of the reference's sample-space API and BasicVariantGenerator
(reference: python/ray/tune/search/sample.py — uniform/loguniform/choice/
randint/grid_search domains; python/ray/tune/search/basic_variant.py —
grid/random variant expansion). Custom searchers plug in via the Searcher
interface (reference: python/ray/tune/search/searcher.py).
"""
from __future__ import annotations

import itertools
import math
import random
from typing import Any, Callable, Iterator


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be positive")
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class SampleFrom(Domain):
    def __init__(self, fn: Callable[[dict], Any]):
        self.fn = fn

    def sample(self, rng):  # resolved against the spec later
        raise TypeError("SampleFrom is resolved with the config, not the rng")


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def sample_from(fn: Callable[[dict], Any]) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def _split_spec(spec: dict, prefix=()) -> tuple[list, list]:
    """Walk the (possibly nested) param space → (grid_items, other_items)
    where each item is (key_path, domain_or_value)."""
    grids, others = [], []
    for k, v in spec.items():
        path = prefix + (k,)
        if isinstance(v, GridSearch):
            grids.append((path, v))
        elif isinstance(v, dict):
            g, o = _split_spec(v, path)
            grids.extend(g)
            others.extend(o)
        else:
            others.append((path, v))
    return grids, others


def _set_path(cfg: dict, path: tuple, value: Any) -> None:
    for k in path[:-1]:
        cfg = cfg.setdefault(k, {})
    cfg[path[-1]] = value


class Searcher:
    """Pluggable suggestion interface (reference: tune/search/searcher.py).
    Subclasses implement suggest() and optionally on_trial_complete()."""

    def set_search_properties(self, metric: str | None, mode: str | None) -> None:
        self.metric, self.mode = metric, mode

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        pass


class SuggestAdapter(Searcher):
    """Bridge an EXTERNAL suggest/observe optimizer into tune — the
    Optuna/HyperOpt adapter pattern (reference:
    tune/search/optuna/optuna_search.py: `ask()` at suggest time, `tell()`
    at completion). The wrapped optimizer needs two methods:

        ask() -> dict | None            # next config (None = budget spent)
        tell(config, value) -> None     # observe an outcome; value is
                                        # normalized so HIGHER IS BETTER
                                        # (None for failed trials)

    max_trials bounds the sweep when the optimizer itself is unbounded.
    """

    def __init__(self, optimizer: Any, *, max_trials: int | None = None):
        self._opt = optimizer
        self._max_trials = max_trials
        self._suggested = 0
        self._live: dict[str, dict] = {}  # trial_id -> config
        self.metric: str | None = None
        self.mode: str | None = None

    def suggest(self, trial_id: str) -> dict | None:
        if self._max_trials is not None and self._suggested >= self._max_trials:
            return None
        cfg = self._opt.ask()
        if cfg is None:
            return None
        self._suggested += 1
        self._live[trial_id] = dict(cfg)
        return dict(cfg)

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None:
            return
        value = None
        if not error and result is not None and self.metric in result:
            value = float(result[self.metric])
            if self.mode == "min":
                value = -value  # adapter contract: higher is better
        try:
            self._opt.tell(cfg, value)
        except Exception:  # noqa: BLE001 — a broken external optimizer must
            pass  #                         not take down the experiment


def _partition_space(param_space: dict, searcher_name: str,
                     allow_choice: bool = True):
    """(dims, fixed, deferred) split shared by the model-based searchers;
    grid domains are rejected uniformly."""
    grids, others = _split_spec(param_space)
    if grids:
        raise ValueError(f"{searcher_name} does not accept grid_search "
                         "domains; use BasicVariantGenerator")
    dims, fixed, deferred = [], [], []
    for path, v in others:
        if not allow_choice and isinstance(v, Choice):
            raise ValueError(
                f"{searcher_name} models numeric domains only (reference "
                "bayesopt has the same limit); use TPESearcher for "
                "categorical spaces")
        if isinstance(v, SampleFrom):
            deferred.append((path, v))
        elif isinstance(v, Domain):
            dims.append((path, v))
        else:
            fixed.append((path, v))
    return dims, fixed, deferred


def _assemble_config(fixed, deferred, dim_values) -> dict:
    """fixed + modeled dim values + deferred sample_from (which may read
    the already-set keys), in that order."""
    cfg: dict = {}
    for path, v in fixed:
        _set_path(cfg, path, v)
    for path, v in dim_values:
        _set_path(cfg, path, v)
    for path, v in deferred:
        _set_path(cfg, path, v.fn(cfg))
    return cfg


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator searcher (Bergstra et al.
    2011) — the model behind Optuna's default sampler and HyperOpt
    (reference integrates those externally via tune/search/optuna/,
    tune/search/hyperopt/; this is an in-tree implementation with no
    dependency, pluggable exactly like them).

    Observations are split at the gamma-quantile into good/bad sets; each
    numeric dimension gets a Parzen (Gaussian-mixture) density per set, and
    candidates drawn from the good density are ranked by the likelihood
    ratio l(x)/g(x). Categorical dims use add-one-smoothed frequencies.
    Until n_startup completions it falls back to random sampling.

    Compose with ASHA for BOHB-style search (model-based suggestions +
    successive-halving early stopping): Tuner(tune_config=TuneConfig(
    searcher=TPESearcher(...), scheduler=ASHAScheduler(...))).
    """

    def __init__(self, param_space: dict, *, metric: str | None = None,
                 mode: str | None = None, n_startup: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24,
                 max_trials: int | None = None, seed: int | None = None):
        self._dims, self._fixed, self._deferred = _partition_space(
            param_space, "TPESearcher")
        self.metric, self.mode = metric, mode
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._max_trials = max_trials
        self._suggested = 0
        self.rng = random.Random(seed)
        self._live: dict[str, dict] = {}
        self._obs: list[tuple[dict, float]] = []  # (flat values, score)

    def set_search_properties(self, metric, mode):
        if self.metric is None:
            self.metric = metric
        if self.mode is None:
            self.mode = mode

    # -- per-dimension densities ------------------------------------------

    @staticmethod
    def _to_unit(domain, x: float) -> float:
        if isinstance(domain, LogUniform):
            lo, hi = math.log(domain.low), math.log(domain.high)
            return (math.log(x) - lo) / (hi - lo)
        return (x - domain.low) / (domain.high - domain.low)

    @staticmethod
    def _from_unit(domain, u: float):
        u = min(max(u, 0.0), 1.0)
        if isinstance(domain, LogUniform):
            lo, hi = math.log(domain.low), math.log(domain.high)
            return math.exp(lo + u * (hi - lo))
        x = domain.low + u * (domain.high - domain.low)
        if isinstance(domain, Randint):
            return min(int(x), domain.high - 1)
        return x

    def _parzen(self, units: list[float]):
        """(centers, bandwidth) in unit space; uniform prior as an extra
        pseudo-center keeps exploration alive."""
        n = len(units)
        bw = max(1.0 / (1 + n) ** 0.5 * 0.5, 0.05)
        return units, bw

    def _sample_parzen(self, centers, bw) -> float:
        c = self.rng.choice(centers) if centers else self.rng.random()
        return self.rng.gauss(c, bw)

    @staticmethod
    def _parzen_pdf(u: float, centers, bw) -> float:
        # mixture of gaussians + a uniform component (weight 1/(n+1))
        n = len(centers)
        if n == 0:
            return 1.0
        s = 0.0
        for c in centers:
            s += math.exp(-0.5 * ((u - c) / bw) ** 2) / (bw * 2.5066282746)
        return (s + 1.0) / (n + 1)

    # -- suggest/observe ---------------------------------------------------

    def _random_config(self) -> dict:
        flat = {path: d.sample(self.rng) for path, d in self._dims}
        return flat

    def _tpe_config(self) -> dict:
        scored = sorted(self._obs, key=lambda o: -o[1])
        n_good = max(1, int(self.gamma * len(scored)))
        good, bad = scored[:n_good], scored[n_good:]
        flat: dict = {}
        for path, d in self._dims:
            if isinstance(d, Choice):
                k = len(d.categories)
                def probs(obs):
                    counts = [1.0] * k
                    for cfg, _ in obs:
                        counts[d.categories.index(cfg[path])] += 1.0
                    t = sum(counts)
                    return [c / t for c in counts]
                pg, pb = probs(good), probs(bad)
                best_i = max(
                    range(k),
                    key=lambda i: (pg[i] / pb[i]) if pb[i] > 0 else pg[i],
                )
                # sample from good-probabilities but biased to the best ratio
                if self.rng.random() < 0.8:
                    flat[path] = d.categories[best_i]
                else:
                    r, acc = self.rng.random(), 0.0
                    for i, p in enumerate(pg):
                        acc += p
                        if r <= acc:
                            flat[path] = d.categories[i]
                            break
                    else:
                        flat[path] = d.categories[-1]
                continue
            gu = [self._to_unit(d, cfg[path]) for cfg, _ in good]
            bu = [self._to_unit(d, cfg[path]) for cfg, _ in bad]
            gc, gbw = self._parzen(gu)
            bc, bbw = self._parzen(bu)
            best_u, best_ratio = None, -1.0
            for _ in range(self.n_candidates):
                u = self._sample_parzen(gc, gbw)
                ratio = (self._parzen_pdf(u, gc, gbw)
                         / max(self._parzen_pdf(u, bc, bbw), 1e-12))
                if ratio > best_ratio:
                    best_u, best_ratio = u, ratio
            flat[path] = self._from_unit(d, best_u)
        return flat

    def suggest(self, trial_id: str) -> dict | None:
        if self._max_trials is not None and self._suggested >= self._max_trials:
            return None
        self._suggested += 1
        if len(self._obs) < self.n_startup:
            flat = self._random_config()
        else:
            flat = self._tpe_config()
        cfg = _assemble_config(self._fixed, self._deferred, flat.items())
        self._live[trial_id] = flat
        return cfg

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        flat = self._live.pop(trial_id, None)
        if flat is None or error or result is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((flat, score))


class TuneBOHB(TPESearcher):
    """BOHB's model-based half (Falkner et al. 2018; reference:
    tune/search/bohb/bohb_search.py TuneBOHB). A TPE model fit
    PER BUDGET: milestone results reported by HyperBandForBOHB land in
    per-budget observation pools, and suggestions are drawn from the model
    of the LARGEST budget that has at least n_startup observations —
    BOHB's defining rule, so early low-budget evidence guides the search
    immediately but is superseded by higher-fidelity evidence as brackets
    deepen. Pair with schedulers.HyperBandForBOHB, which feeds
    on_budget_result at every milestone barrier."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._budget_obs: dict[float, list[tuple[dict, float]]] = {}

    def on_budget_result(self, trial_id: str, budget: float,
                         result: dict) -> None:
        flat = self._live.get(trial_id)
        if flat is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._budget_obs.setdefault(float(budget), []).append((flat, score))

    def _select_pool(self) -> list[tuple[dict, float]]:
        # completions ran to max_t — the HIGHEST fidelity pool of all, so
        # it is consulted first, then milestone pools in descending budget
        if len(self._obs) >= self.n_startup:
            return self._obs
        for budget in sorted(self._budget_obs, reverse=True):
            pool = self._budget_obs[budget]
            if len(pool) >= self.n_startup:
                return pool
        return self._obs

    def suggest(self, trial_id: str) -> dict | None:
        pool = self._select_pool()
        # swap the pool the parent's model fits on for this suggestion
        saved, self._obs = self._obs, pool
        try:
            return super().suggest(trial_id)
        finally:
            self._obs = saved


class BayesOptSearcher(Searcher):
    """Native GP-UCB Bayesian optimization (reference:
    tune/search/bayesopt/bayesopt_search.py, which wraps the external
    `bayesian-optimization` package; this is an in-tree numpy RBF-GP —
    the same regressor PB2 uses — with an upper-confidence-bound
    acquisition over unit-cube candidates). Numeric domains only, like
    the reference (categoricals want TPESearcher)."""

    def __init__(self, param_space: dict, *, metric: str | None = None,
                 mode: str | None = None, n_startup: int = 5,
                 kappa: float = 2.0, n_candidates: int = 256,
                 max_trials: int | None = None, seed: int | None = None):
        self._dims, self._fixed, self._deferred = _partition_space(
            param_space, "BayesOptSearcher", allow_choice=False)
        self.metric, self.mode = metric, mode
        self.n_startup = n_startup
        self.kappa = kappa
        self.n_candidates = n_candidates
        self._max_trials = max_trials
        self._suggested = 0
        self.rng = random.Random(seed)
        self._live: dict[str, dict] = {}   # trial_id -> unit coords
        self._obs: list[tuple[list[float], float]] = []

    def set_search_properties(self, metric, mode):
        if self.metric is None:
            self.metric = metric
        if self.mode is None:
            self.mode = mode

    def _acquire(self) -> list[float]:
        import numpy as np

        from ray_tpu_torch.tune._gp import gp_ucb_select

        d = len(self._dims)
        cand = np.array([[self.rng.random() for _ in range(d)]
                         for _ in range(self.n_candidates)])
        best = gp_ucb_select([u for u, _ in self._obs],
                             [s for _, s in self._obs], cand,
                             ls=0.2, noise=1e-4, kappa=self.kappa)
        return [float(u) for u in best]

    def suggest(self, trial_id: str) -> dict | None:
        if self._max_trials is not None and self._suggested >= self._max_trials:
            return None
        self._suggested += 1
        if len(self._obs) < self.n_startup:
            units = [self.rng.random() for _ in self._dims]
        else:
            units = self._acquire()
        cfg = _assemble_config(
            self._fixed, self._deferred,
            [(path, TPESearcher._from_unit(dom, u))
             for (path, dom), u in zip(self._dims, units)])
        self._live[trial_id] = units
        return cfg

    def on_trial_complete(self, trial_id: str, result: dict | None = None,
                          error: bool = False) -> None:
        units = self._live.pop(trial_id, None)
        if units is None or error or result is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((units, score))


class BasicVariantGenerator(Searcher):
    """Grid x random expansion: the cross-product of all grid_search values,
    repeated num_samples times with random domains re-sampled per repeat."""

    def __init__(self, param_space: dict, num_samples: int = 1, seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._iter = self._generate()

    def _generate(self) -> Iterator[dict]:
        grids, others = _split_spec(self.param_space)
        grid_paths = [p for p, _ in grids]
        grid_values = [g.values for _, g in grids]
        combos = list(itertools.product(*grid_values)) if grids else [()]
        for _ in range(self.num_samples):
            for combo in combos:
                cfg: dict = {}
                for path, val in zip(grid_paths, combo):
                    _set_path(cfg, path, val)
                deferred = []
                for path, v in others:
                    if isinstance(v, Domain):
                        if isinstance(v, SampleFrom):
                            deferred.append((path, v))
                        else:
                            _set_path(cfg, path, v.sample(self.rng))
                    else:
                        _set_path(cfg, path, v)
                for path, v in deferred:
                    _set_path(cfg, path, v.fn(cfg))
                yield cfg

    def suggest(self, trial_id: str) -> dict | None:
        return next(self._iter, None)
