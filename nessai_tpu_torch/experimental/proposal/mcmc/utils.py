"""Autocorrelation of MCMC chains (emcee-style integrated
autocorrelation time). Counterpart of
``nessai_tpu/experimental/proposal/mcmc/utils.py``, in numpy on the host:
one batched FFT over every walker and dimension."""

import numpy as np

__all__ = [
    "next_pow_two",
    "function_1d",
    "auto_window",
    "integrated_time",
]


def next_pow_two(n: int) -> int:
    """Smallest power of two >= ``n``."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def _acf_batch(x):
    """Normalised autocorrelation along axis 0 of a [n_t, ...] batch."""
    n_t = x.shape[0]
    n = next_pow_two(n_t)
    f = np.fft.fft(x - x.mean(axis=0), n=2 * n, axis=0)
    acf = np.fft.ifft(f * np.conjugate(f), axis=0)[:n_t].real
    norm = acf[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(norm == 0.0, np.nan_to_num(np.inf), acf / norm)
    return out


def function_1d(x):
    """Normalised autocorrelation function of a 1-D series."""
    x = np.atleast_1d(np.asarray(x, dtype=float))
    if x.ndim != 1:
        raise ValueError("invalid dimensions for 1D autocorrelation function")
    return _acf_batch(x)


def auto_window(taus, c):
    """Automated windowing after Sokal: the first lag where ``lag >= c *
    tau``."""
    m = np.arange(len(taus)) < c * np.asarray(taus)
    if np.any(m):
        return int(np.argmin(m))
    return len(taus) - 1


def integrated_time(x, c: int = 5):
    """Integrated autocorrelation time of a chain ensemble ``x``
    ([n_steps, n_walkers, n_dims]) with Sokal's windowing constant ``c``:
    the estimate for each dimension (shape [n_dims]), from the
    walker-averaged autocorrelation function."""
    x = np.asarray(x, dtype=float)
    if x.ndim != 3:
        raise ValueError("integrated_time expects a [n_steps, n_walkers, n_dims] array")
    f = _acf_batch(x).mean(axis=1)
    taus = 2.0 * np.cumsum(f, axis=0) - 1.0
    out = np.empty(x.shape[2])
    for d in range(x.shape[2]):
        out[d] = taus[auto_window(taus[:, d], c), d]
    return out
