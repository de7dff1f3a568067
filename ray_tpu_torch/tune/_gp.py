"""Shared numpy RBF-GP UCB selection (the port's copy of
``ray_tpu/tune/_gp.py``) — the one regressor behind PB2's
explore step and BayesOptSearcher's acquisition (reference wraps GPy /
bayesian-optimization respectively; population sizes of tens of points
don't need more)."""
from __future__ import annotations

import numpy as np


def gp_ucb_select(X, y, cand, *, ls: float = 0.3, noise: float = 1e-3,
                  kappa: float = 1.0) -> np.ndarray:
    """Fit an RBF GP on (X, y) (inputs in the unit cube) and return the
    candidate row maximizing mean + kappa * std."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    cand = np.asarray(cand, np.float64)
    y_mean, y_std = y.mean(), y.std() or 1.0
    yn = (y - y_mean) / y_std

    def rbf(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * ls * ls))

    K = rbf(X, X) + noise * np.eye(len(X))
    Ks = rbf(cand, X)
    alpha = np.linalg.solve(K, yn)
    mu = Ks @ alpha
    v = np.linalg.solve(K, Ks.T)
    var = np.clip(1.0 - (Ks * v.T).sum(-1), 1e-9, None)
    ucb = mu + kappa * np.sqrt(var)
    return cand[int(np.argmax(ucb))]
