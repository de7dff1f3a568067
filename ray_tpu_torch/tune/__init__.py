"""ray_tpu_torch.tune — hyperparameter search over trial actors (the
port's copy of ``ray_tpu/tune``, with the same names and exports).

Equivalent of the reference's Tune (reference: python/ray/tune — Tuner
tuner.py:59, TuneController execution/tune_controller.py:81, schedulers/,
search/). Trials are actors on the port's core; a trial that asks for
``GPU`` through ``TuneController(resources_per_trial=...)`` holds whole
cards, so concurrent trials never share a card, and sees them through
``CUDA_VISIBLE_DEVICES``. Checkpoints are the port's Train ``Checkpoint``.
"""
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandForBOHB,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    PopulationBasedTrainingReplay,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    SuggestAdapter,
    BasicVariantGenerator,
    Searcher,
    BayesOptSearcher,
    TPESearcher,
    TuneBOHB,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.session import get_checkpoint, report
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    TuneConfig,
    TuneResult,
    TuneRunConfig,
    Tuner,
)

__all__ = [
    "SuggestAdapter",
    "ASHAScheduler",
    "HyperBandForBOHB",
    "HyperBandScheduler",
    "PB2",
    "PopulationBasedTrainingReplay",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "Trial",
    "TrialScheduler",
    "TuneConfig",
    "TuneResult",
    "TuneRunConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "BayesOptSearcher",
    "TPESearcher",
    "TuneBOHB",
    "loguniform",
    "randint",
    "report",
    "sample_from",
    "uniform",
]

