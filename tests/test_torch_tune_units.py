"""The port's Tune units (``ray_tpu_torch.tune``: searchers, schedulers,
``Trial``) against the JAX package's, with no cluster: each case runs the
same script through both packages.

- Every searcher, given the same seed and the same ``suggest`` /
  ``on_trial_complete`` sequence (and, for ``TuneBOHB``, the same budget
  results), suggests equal configs.
- Every scheduler, given the same scripted result streams over each
  package's own ``Trial``s, gives equal decisions, equal
  ``pending_actions``, equal PBT / PB2 exploit configs and restore paths,
  and an equal PBT policy log; ``PopulationBasedTrainingReplay`` replays
  a log to equal switches.
- ``Trial.to_json`` round trips give equal output.
- ``ResultGrid``'s two dataframe views equal the JAX package's, and name
  pandas in their ``ImportError`` where it is missing."""
from __future__ import annotations

import importlib
import json
import math
import os
import sys

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


def _tune(pkg):
    if pkg == "ray_tpu":
        pytest.importorskip("jax")
    return importlib.import_module(pkg + ".tune")


def _both(fn):
    """``fn(pkg)`` for each package; -> (JAX's, the port's)."""
    return tuple(fn(pkg) for pkg in PKGS)


# ------------------------------------------------------------- searchers

def _objective(cfg) -> float:
    """A smooth objective of the spaces below (lower is better)."""
    out = (math.log10(cfg["lr"]) + 2.5) ** 2 + (cfg.get("wd", 0.5) - 0.3) ** 2
    if "act" in cfg:
        out += 0.2 * (cfg["act"] != "gelu")
    if "layers" in cfg:
        out += 0.05 * abs(cfg["layers"] - 3)
    return out


def _space(tune, kind):
    if kind == "grid":
        return {"lr": tune.grid_search([1e-4, 1e-3, 1e-2]),
                "nest": {"wd": tune.uniform(0.0, 1.0)},
                "act": tune.choice(["relu", "gelu", "silu"]),
                "layers": tune.randint(1, 6),
                "twice": tune.sample_from(lambda c: c["lr"] * 2)}
    space = {"lr": tune.loguniform(1e-5, 1e-1), "wd": tune.uniform(0.0, 1.0),
             "fixed": 7, "twice": tune.sample_from(lambda c: c["lr"] * 2)}
    if kind == "tpe":
        space.update(act=tune.choice(["relu", "gelu", "silu"]),
                     layers=tune.randint(1, 6))
    return space


class _Ask:
    """A deterministic external optimizer for ``SuggestAdapter``: a fixed
    list of configs, and every ``tell`` kept."""

    def __init__(self):
        self.told = []
        self._i = 0

    def ask(self):
        self._i += 1
        return {"lr": 10 ** (-1 - self._i % 4), "wd": 0.1 * self._i}

    def tell(self, config, value):
        self.told.append((config, value))


def _searcher(tune, kind):
    if kind == "grid":
        return tune.BasicVariantGenerator(_space(tune, kind), num_samples=2,
                                          seed=3)
    if kind == "random":
        return tune.BasicVariantGenerator(_space(tune, kind), num_samples=9,
                                          seed=5)
    if kind == "tpe":
        return tune.TPESearcher(_space(tune, kind), n_startup=4, seed=11,
                                max_trials=14)
    if kind == "bohb":
        return tune.TuneBOHB(_space(tune, kind), n_startup=3, seed=13,
                             max_trials=12)
    if kind == "bayesopt":
        return tune.BayesOptSearcher(_space(tune, kind), n_startup=3, seed=17,
                                     n_candidates=64, max_trials=10)
    return tune.SuggestAdapter(_Ask(), max_trials=8)


def _search_script(pkg, kind):
    tune = _tune(pkg)
    s = _searcher(tune, kind)
    s.set_search_properties("loss", "min")
    out = []
    for i in range(20):
        tid = f"t{i:02d}"
        cfg = s.suggest(tid)
        if cfg is None:
            break
        flat = {**cfg, **cfg.get("nest", {})}
        loss = _objective(flat)
        if kind == "bohb":  # a milestone result first, as HyperBand feeds it
            s.on_budget_result(tid, 1.0, {"loss": loss + 0.5})
        if i % 5 == 4:
            s.on_trial_complete(tid, error=True)
        else:
            s.on_trial_complete(tid, {"loss": loss})
        out.append(cfg)
    if kind == "adapter":
        out.append(s._opt.told)
    return out


@pytest.mark.parametrize("kind", ["grid", "random", "tpe", "bohb",
                                  "bayesopt", "adapter"])
def test_searchers_suggest_equal_configs(kind):
    jax_cfgs, port_cfgs = _both(lambda pkg: _search_script(pkg, kind))
    assert len(port_cfgs) >= 6
    assert port_cfgs == jax_cfgs


def test_model_searchers_refuse_grids_and_categoricals_alike():
    def refusals(pkg):
        tune = _tune(pkg)
        out = []
        for make in (
            lambda: tune.TPESearcher({"a": tune.grid_search([1, 2])}),
            lambda: tune.BayesOptSearcher({"a": tune.choice([1, 2])}),
            lambda: tune.loguniform(0.0, 1.0),
        ):
            with pytest.raises(ValueError) as e:
                make()
            out.append(str(e.value))
        return out

    jax_out, port_out = _both(refusals)
    assert port_out == jax_out


# ------------------------------------------------------------ schedulers

def _score(cfg, it) -> float:
    """Loss of a trial of ``cfg`` at iteration ``it``: falls with ``it``,
    fastest near lr 0.3; a NaN for the lr-0.9 trial at iteration 5."""
    if cfg["lr"] == 0.9 and it == 5:
        return float("nan")
    return (1.0 + abs(cfg["lr"] - 0.3) * 3) / it + 0.01 * cfg["id"]


def _schedulers(tune, kind, tmp):
    if kind == "fifo":
        return tune.FIFOScheduler()
    if kind == "asha":
        return tune.ASHAScheduler(grace_period=1, reduction_factor=2, max_t=8)
    if kind == "asha_brackets":
        return tune.AsyncHyperBandScheduler(grace_period=1, reduction_factor=3,
                                            max_t=9, brackets=2)
    if kind == "median":
        return tune.MedianStoppingRule(grace_period=2, min_samples_required=2)
    if kind == "pbt":
        return tune.PopulationBasedTraining(
            perturbation_interval=2, quantile_fraction=0.34, seed=5,
            hyperparam_mutations={"lr": [0.05, 0.1, 0.3, 0.6, 0.9],
                                  "wd": {"lower": 0.0, "upper": 1.0},
                                  "flag": lambda: "mutated"},
            resample_probability=0.3, policy_log_dir=os.path.join(tmp, "log"))
    if kind == "pb2":
        return tune.PB2(perturbation_interval=2, quantile_fraction=0.34,
                        hyperparam_bounds={"lr": [0.01, 1.0],
                                           "wd": [0.0, 1.0]},
                        n_candidates=32, seed=9)
    if kind == "hyperband":
        return tune.HyperBandScheduler(grace_period=1, reduction_factor=2,
                                       max_t=8)
    # HyperBandForBOHB linked to a TuneBOHB searcher, whose budget pools
    # are compared too
    searcher = tune.TuneBOHB({"lr": tune.uniform(0.0, 1.0)}, n_startup=2,
                             seed=1, metric="loss", mode="min")
    return tune.HyperBandForBOHB(grace_period=1, reduction_factor=2, max_t=8,
                                 searcher=searcher)


def _scheduler_script(pkg, kind, tmp, n=6, rounds=10):
    """Trials t0..t(n-1) report in turn each round (a paused or stopped
    trial is skipped) with a checkpoint path per report; t3 fails at
    round 4 (``on_trial_complete``). -> every decision and exploit, the
    pending actions after each round, and the policy log."""
    tune = _tune(pkg)
    trial_mod = importlib.import_module(pkg + ".tune.trial")
    tmp = os.path.join(tmp, pkg)
    sched = _schedulers(tune, kind, tmp)
    sched.set_search_properties("loss", "min")
    if kind == "bohb":
        for i in range(n):
            sched._searcher._live[f"t{i}"] = {("lr",): 0.1 * i}
    trials = [trial_mod.Trial(
        config={"lr": [0.05, 0.1, 0.3, 0.6, 0.9, 0.2][i % 6], "wd": 0.5,
                "flag": "orig", "id": i},
        experiment_dir=tmp, trial_id=f"t{i}") for i in range(n)]
    for t in trials:
        sched.on_trial_add(t)
    live = {t.trial_id for t in trials}
    paused: set = set()
    log = []
    for r in range(1, rounds + 1):
        for t in trials:
            if t.trial_id not in live or t.trial_id in paused:
                continue
            if t.trial_id == "t3" and r == 4:
                live.discard(t.trial_id)
                sched.on_trial_complete(t)
                log.append(["failed", t.trial_id])
                continue
            t.iteration += 1
            t.checkpoint_path = f"/ckpt/{t.trial_id}/{t.iteration}"
            result = {"loss": _score(t.config, t.iteration),
                      "training_iteration": t.iteration}
            t.last_result = result
            decision = sched.on_trial_result(t, result)
            entry = [t.trial_id, t.iteration, decision]
            if decision == "EXPLOIT":
                entry += [dict(t.config), t.restore_path]
                t.restore_path = None
            elif decision == "STOP":
                live.discard(t.trial_id)
            elif decision == "PAUSE":
                paused.add(t.trial_id)
            log.append(entry)
        actions = sched.pending_actions()
        log.append(["actions", sorted(actions.items())])
        for tid, verdict in actions.items():
            paused.discard(tid)
            if verdict == "STOP":
                live.discard(tid)
    for t in trials:
        if t.trial_id in live:
            sched.on_trial_complete(t)
    policy = {}
    logdir = os.path.join(tmp, "log")
    if os.path.isdir(logdir):
        for name in sorted(os.listdir(logdir)):
            with open(os.path.join(logdir, name)) as f:
                policy[name] = f.read()
    out = {"log": log, "policy": policy}
    if kind == "bohb":
        out["pools"] = {b: [(dict(c), s) for c, s in pool]
                        for b, pool in sched._searcher._budget_obs.items()}
    return out


@pytest.mark.parametrize("kind", ["fifo", "asha", "asha_brackets", "median",
                                  "pbt", "pb2", "hyperband", "bohb"])
def test_schedulers_decide_alike(kind, tmp_path):
    jax_out, port_out = _both(
        lambda pkg: _scheduler_script(pkg, kind, str(tmp_path)))
    assert port_out == jax_out
    decisions = {e[2] for e in port_out["log"] if len(e) > 2}
    expect = {"fifo": {"CONTINUE"}, "asha": {"STOP"}, "asha_brackets": {"STOP"},
              "median": {"STOP"}, "pbt": {"EXPLOIT"}, "pb2": {"EXPLOIT"},
              "hyperband": {"PAUSE"}, "bohb": {"PAUSE"}}[kind]
    assert expect <= decisions, decisions  # the script reaches the case
    if kind == "pbt":
        assert port_out["policy"]
    if kind in ("hyperband", "bohb"):
        assert any(e[0] == "actions" and e[1] for e in port_out["log"])
    if kind == "bohb":
        assert port_out["pools"]


def test_pbt_replay_applies_the_log_alike(tmp_path):
    """Both replays of one policy log switch configs at the same
    iterations and restore the trial's own checkpoint."""
    path = tmp_path / "pbt_policy_t1.jsonl"
    path.write_text("".join(json.dumps(x) + "\n" for x in (
        {"t": 4, "config": {"lr": 0.3}}, {"t": 2, "config": {"lr": 0.1}},
        {"t": 7, "config": {"lr": 0.6}})))

    def replay(pkg):
        tune = _tune(pkg)
        trial_mod = importlib.import_module(pkg + ".tune.trial")
        sched = tune.PopulationBasedTrainingReplay(str(path))
        t = trial_mod.Trial(config={"lr": 0.05}, experiment_dir=str(tmp_path),
                            trial_id="t1")
        out = []
        for it in range(1, 10):
            t.iteration = it
            t.checkpoint_path = f"/ckpt/{it}"
            d = sched.on_trial_result(t, {"loss": 1.0 / it,
                                          "training_iteration": it})
            out.append((it, d, dict(t.config), t.restore_path))
        return out

    jax_out, port_out = _both(replay)
    assert port_out == jax_out
    assert [x[0] for x in port_out if x[1] == "EXPLOIT"] == [2, 4, 7]


def test_pb2_needs_bounds_alike():
    def refusal(pkg):
        with pytest.raises(ValueError) as e:
            _tune(pkg).PB2()
        return str(e.value)

    jax_out, port_out = _both(refusal)
    assert port_out == jax_out


def test_gp_ucb_select_equal():
    import numpy as np

    rng = np.random.default_rng(0)
    X, y, cand = rng.random((12, 3)), rng.random(12), rng.random((40, 3))

    def pick(pkg):
        if pkg == "ray_tpu":
            pytest.importorskip("jax")
        gp = importlib.import_module(pkg + ".tune._gp")
        return [gp.gp_ucb_select(X, y, cand, kappa=k).tolist()
                for k in (0.0, 1.0, 3.0)]

    jax_out, port_out = _both(pick)
    assert port_out == jax_out


# ------------------------------------------------------------------ trial

@pytest.mark.parametrize("status", ["PENDING", "RUNNING", "PAUSED",
                                    "TERMINATED", "ERROR"])
def test_trial_json_round_trip(status, tmp_path):
    def round_trip(pkg):
        _tune(pkg)
        trial_mod = importlib.import_module(pkg + ".tune.trial")
        t = trial_mod.Trial(config={"lr": 0.1, "nest": {"a": [1, 2]}},
                            experiment_dir=str(tmp_path), trial_id="abc12345")
        t.status = getattr(trial_mod, status)
        t.last_result = {"loss": 0.5, "training_iteration": 3}
        t.error = "boom" if status == "ERROR" else None
        t.checkpoint_path = "/x/checkpoint_000003"
        t.iteration = 3
        first = json.loads(json.dumps(t.to_json()))
        back = trial_mod.Trial.from_json(first, str(tmp_path))
        return first, back.to_json(), back.metric_value("loss")

    jax_out, port_out = _both(round_trip)
    assert port_out == jax_out
    assert port_out[0] == port_out[1]


# ----------------------------------------------------------- result grid

def _grid(pkg, tmp_path):
    tune = _tune(pkg)
    trials = []
    for i, lr in enumerate((0.1, 0.3)):
        t = tune.Trial(config={"lr": lr, "nest": {"a": 1}},
                       experiment_dir=str(tmp_path), trial_id=f"t{i}")
        t.results = [{"loss": lr * k, "training_iteration": k}
                     for k in (1, 2)]
        t.last_result = t.results[-1]
        t.status = "TERMINATED"
        trials.append(t)
    return tune.ResultGrid(trials, "loss", "min")


def test_dataframe_views_equal(tmp_path):
    pytest.importorskip("pandas")

    def views(pkg):
        grid = _grid(pkg, tmp_path)
        return (grid.get_dataframe().to_dict(),
                grid[1].metrics_dataframe.to_dict(),
                grid.get_best_result().config)

    jax_out, port_out = _both(views)
    assert port_out == jax_out


def test_dataframe_views_name_pandas_where_it_is_missing(tmp_path,
                                                         monkeypatch):
    grid = _grid("ray_tpu_torch", tmp_path)
    monkeypatch.setitem(sys.modules, "pandas", None)  # import pandas raises
    with pytest.raises(ImportError, match="get_dataframe needs pandas"):
        grid.get_dataframe()
    with pytest.raises(ImportError, match="metrics_dataframe needs pandas"):
        grid[0].metrics_dataframe
