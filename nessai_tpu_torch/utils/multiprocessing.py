"""Batched and pooled evaluation of host functions. Counterpart of
``nessai_tpu/utils/multiprocessing.py``.

A model with a device likelihood (``torch_log_likelihood``) evaluates
it on the device and never through a pool. The ``multiprocessing.Pool``
path serves host likelihoods, such as scalar pure-Python ones: its
workers are forked with the model in a module global
(:func:`initialise_pool_variables`) and run only host code, so a forked
worker never touches CUDA.
"""

import logging
import multiprocessing
import signal

import numpy as np

from .structures import array_split_chunksize

logger = logging.getLogger(__name__)

__all__ = [
    "initialise_pool_variables",
    "initialise_pool_worker",
    "forking_pool",
    "get_n_pool",
    "check_multiprocessing_start_method",
    "log_likelihood_wrapper",
    "log_prior_wrapper",
    "log_prior_unit_hypercube_wrapper",
    "batch_evaluate_function",
    "check_vectorised_function",
]

_model = None


def initialise_pool_variables(model) -> None:
    """Store the model in a global for fork-shared pool workers."""
    global _model
    _model = model


#: A pool worker's dispositions of the signals that ``FlowSampler``
#: checkpoints on: the parent handles them (a checkpoint, then it closes
#: or terminates the pool), so a worker ignores SIGINT and ends on
#: SIGTERM or SIGALRM.
WORKER_SIGNALS = {signal.SIGTERM: signal.SIG_DFL, signal.SIGALRM: signal.SIG_DFL, signal.SIGINT: signal.SIG_IGN}


def initialise_pool_worker(model) -> None:
    """The initializer of the pool's forked workers: the model in the
    global of :func:`initialise_pool_variables`, and the signal
    dispositions of :data:`WORKER_SIGNALS`. A forked worker inherits the
    parent's Python handlers; the sampler's would run in the worker on
    the pool's terminate (SIGTERM), write a checkpoint of the run as it
    was at the fork over the parent's, and exit holding whatever lock the
    fork copied, so that the parent waits for it for ever. The worker
    starts with these signals blocked (:func:`forking_pool`) and unblocks
    them once its dispositions are set."""
    initialise_pool_variables(model)
    for signum, disposition in WORKER_SIGNALS.items():
        signal.signal(signum, disposition)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, WORKER_SIGNALS)


def forking_pool(model, n_pool: int):
    """A ``multiprocessing.Pool`` of ``n_pool`` forked workers sharing
    ``model`` (:func:`initialise_pool_worker`). The signals of
    :data:`WORKER_SIGNALS` are blocked while the pool and its threads are
    made, so that every worker, forked then or later by the pool's
    threads, holds a signal sent before its initializer ran (a terminate
    of a pool whose workers are still starting) until its dispositions
    are set: it then ends, where with the parent's handler it would run
    that handler, live on and keep the pool's join waiting."""
    blocked = signal.pthread_sigmask(signal.SIG_BLOCK, WORKER_SIGNALS)
    try:
        return multiprocessing.get_context("fork").Pool(
            processes=n_pool, initializer=initialise_pool_worker, initargs=(model,)
        )
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, blocked)


def check_multiprocessing_start_method() -> None:
    """Warn if the start method is not fork (global-model sharing relies on
    it)."""
    method = multiprocessing.get_start_method(allow_none=True)
    if method not in (None, "fork"):
        logger.warning(
            "Multiprocessing start method is '%s', not 'fork'. "
            "This may lead to high memory usage or errors: the pool "
            "relies on fork-shared globals — call "
            "initialise_pool_variables in the initializer.",
            method,
        )


def get_n_pool(pool):
    """Determine the number of workers in a pool object."""
    if pool is None:
        return None
    if hasattr(pool, "_processes"):
        return pool._processes
    if hasattr(pool, "_max_workers"):
        return pool._max_workers
    if hasattr(pool, "_actor_pool"):
        # ray.util.multiprocessing.Pool
        return len(pool._actor_pool)
    logger.warning("Could not determine number of processes in pool")
    return None


def log_likelihood_wrapper(x):
    """The model's log-likelihood in a pool worker."""
    return _model.log_likelihood(x)


def log_prior_wrapper(x):
    return _model.log_prior(x)


def log_prior_unit_hypercube_wrapper(x):
    return _model.log_prior_unit_hypercube(x)


def batch_evaluate_function(
    func,
    x,
    vectorised: bool,
    chunksize: int = None,
    func_wrapper=None,
    n_pool: int = None,
    pool=None,
):
    """Evaluate ``func`` over the rows of ``x``.

    Four paths: vectorised (optionally in chunks of ``chunksize``),
    scalar loop, pooled-vectorised, pooled-scalar."""
    if pool is None or n_pool is None:
        if vectorised:
            if chunksize:
                out = np.concatenate(
                    [
                        np.atleast_1d(func(xx))
                        for xx in array_split_chunksize(x, chunksize)
                    ]
                )
            else:
                out = func(x)
        else:
            out = np.array([func(xx) for xx in x])
    else:
        if func_wrapper is None:
            func_wrapper = func
        if vectorised:
            chunks = (
                array_split_chunksize(x, chunksize)
                if chunksize
                else np.array_split(x, n_pool)
            )
            out = np.concatenate(
                [np.atleast_1d(r) for r in pool.map(func_wrapper, chunks)]
            )
        else:
            out = np.array(pool.map(func_wrapper, x))
    return np.asarray(out).flatten()


def check_vectorised_function(func, x, dtype="float64", atol=1e-15, rtol=1e-15):
    """Check that ``func`` applied to a batch matches per-row application."""
    if len(x) <= 1:
        raise ValueError("Input has length <= 1")
    try:
        batch = np.asarray(func(x), dtype=dtype).flatten()
    except (TypeError, ValueError, IndexError, AttributeError):
        return False
    if batch.shape != (len(x),):
        return False
    single = np.array([func(xx) for xx in x], dtype=dtype).flatten()
    return np.allclose(batch, single, atol=atol, rtol=rtol, equal_nan=True)
