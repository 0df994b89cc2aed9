"""Predictive metrics and information criteria (copy of the JAX package's
`utils/metrics.py`): RMSE, LPD, 95%-CI length and coverage (reference
nmgp_dsvi.py:1050-1068, SIM_code/Utility/utils.py:165-197), and AIC, BIC
and DIC (reference SIM_code/Utility/model_validation.py:9-51).

The predictive metrics take numpy arrays or CPU tensors (`np.asarray` reads
both).  The criteria take a deviance function of the port
(`models.logdensities.*_deviance`, (C, dim) -> (C,)) and its parameters as
an array or a tensor on any device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["mse", "rmse", "lpd", "ci_length_and_coverage", "predictive_summary", "aic", "bic", "dic"]


def mse(x, y, axis=None):
    return np.mean((np.asarray(x) - np.asarray(y)) ** 2, axis=axis)


def rmse(x, y, axis=None):
    return np.sqrt(mse(x, y, axis=axis))


def lpd(mean_array, std_array, y_array):
    """Mean log predictive density (reference utils.py:185-197), vectorized."""
    from scipy.stats import norm

    m = np.asarray(mean_array).reshape(-1)
    s = np.asarray(std_array).reshape(-1)
    y = np.asarray(y_array).reshape(-1)
    return float(np.mean(norm.logpdf(y, loc=m, scale=s)))


def ci_length_and_coverage(samples, y_true, q=(2.5, 97.5), test_index=None, dim_outputs=None):
    """95% central-interval mean length + empirical coverage.

    `samples`: (S, N) posterior predictive draws; `y_true`: (N,).  Coverage
    is per output when `test_index` is given, else global.
    """
    samples = np.asarray(samples)
    y_true = np.asarray(y_true).reshape(-1)
    lo, hi = np.percentile(samples, q=q, axis=0)
    length = float(np.mean(hi - lo))
    inside = (y_true > lo) & (y_true < hi)
    if test_index is None:
        return length, float(np.mean(inside))
    test_index = np.asarray(test_index).reshape(-1).astype(int)
    D = dim_outputs or int(test_index.max()) + 1
    cov = np.array([inside[test_index == d].mean() for d in range(D)])
    return length, cov


def predictive_summary(samples, y_true, test_index=None, dim_outputs=None):
    """RMSE of the posterior mean + CI length + coverage in one call."""
    mean = np.mean(np.asarray(samples), axis=0)
    r = rmse(mean, np.asarray(y_true).reshape(-1))
    length, cov = ci_length_and_coverage(
        samples, y_true, test_index=test_index, dim_outputs=dim_outputs
    )
    return float(r), length, cov


# ---------------------------------------------------------------------------
# Information criteria (reference model_validation.py:9-51)
# ---------------------------------------------------------------------------


def _as_pars(pars):
    return pars if isinstance(pars, torch.Tensor) else torch.as_tensor(np.asarray(pars))


def aic(pars, deviance_func: Callable, *args, **kwargs):
    n_p = pars.shape[0]
    return float(deviance_func(_as_pars(pars), *args, **kwargs)) + 2 * n_p


def bic(pars, deviance_func: Callable, n_obs: int, *args, **kwargs):
    n_p = pars.shape[0]
    return float(deviance_func(_as_pars(pars), *args, **kwargs)) + np.log(n_obs) * n_p


def dic(pars_hist, deviance_func: Callable, *args, **kwargs):
    """DIC of the draws `pars_hist` (S, dim): the mean deviance plus its
    excess over the deviance at the mean draw.  The deviance of all draws
    is one call over the leading axis; the means are numpy's, as in the JAX
    loop."""
    hist = _as_pars(pars_hist)
    devs = deviance_func(hist, *args, **kwargs).detach().double().cpu().numpy()
    bar_d = devs.mean()
    mean = hist.detach().cpu().numpy().mean(axis=0)
    at_mean = deviance_func(torch.as_tensor(mean, dtype=hist.dtype, device=hist.device), *args,
                            **kwargs)
    p_d = bar_d - float(at_mean)
    return float(bar_d + p_d)
