"""The likelihood pool and signal handling of the port: a pooled run
gives the same bits as an unpooled one, the pool closes and stays out of
pickles, chunked likelihoods agree with one batch, and SIGTERM ends a
run with exit code 130 and a checkpoint that loads. Every test has its
own time limit: a forked worker that hangs fails the test instead of
stalling the run."""

import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from nessai_tpu_torch.flowsampler import FlowSampler
from nessai_tpu_torch.livepoint import numpy_array_to_live_points
from nessai_tpu_torch.utils.testing import IntegrationTestModel, time_limit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(
    nlive=50,
    seed=9,
    flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1),
    training_config=dict(max_epochs=5, patience=3),
    plot=False,
    checkpointing=False,
    device="cpu",
    signal_handling=False,
)


def _host_model():
    model = IntegrationTestModel(2)
    model.torch_log_likelihood = None
    return model


def test_pooled_run_gives_the_same_bits(tmp_path):
    """A host likelihood evaluated by two worker processes gives the same
    logZ, iterations and likelihood count as in this process; the run
    closes the pool."""
    results = []
    for n_pool in (None, 2):
        model = _host_model()
        fs = FlowSampler(model, output=str(tmp_path / str(n_pool)), n_pool=n_pool, **RUN)
        assert (model.pool is not None) == bool(n_pool)
        with time_limit(120):
            fs.run(plot=False, save=False)
        assert model.pool is None
        results.append((fs.logZ, fs.ns.iteration, model.likelihood_evaluations))
    assert results[0] == results[1]


@pytest.mark.parametrize("code", [2, None])
def test_close_pool(code):
    """``close_pool`` terminates the pool for code 2 and closes it
    otherwise; either way the workers are joined and the pool is gone."""
    model = _host_model()
    with time_limit(60):
        model.configure_pool(n_pool=2)
        pool = model.pool
        assert model.n_pool == 2 and model._pool_configured
        x = numpy_array_to_live_points(np.random.default_rng(1).normal(size=(10, 2)), model.names)
        model.set_rng(np.random.default_rng(2))
        np.testing.assert_array_equal(model.batch_evaluate_log_likelihood(x), model.log_likelihood(x))
        model.close_pool(code=code)
    assert model.pool is None and not model._pool_configured
    with pytest.raises(ValueError):
        pool.map(abs, [1])


def test_workers_do_not_run_the_parents_signal_handlers(tmp_path):
    """The pool's workers do not inherit the process's signal handlers
    (the sampler's checkpoint-and-exit, here a marker): they end on
    SIGTERM and SIGALRM and ignore SIGINT, so terminating the pool runs
    no handler in a worker and waits for none."""
    marker = tmp_path / "handled"

    def handler(signum, frame):
        marker.write_text(f"{signum} {os.getpid()}")

    signals = (signal.SIGTERM, signal.SIGALRM, signal.SIGINT)
    previous = {s: signal.signal(s, handler) for s in signals}
    try:
        model = _host_model()
        with time_limit(60):
            model.configure_pool(n_pool=2)
            dispositions = model.pool.map(signal.getsignal, signals, chunksize=1)
            model.close_pool(code=2)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    assert dispositions == [signal.SIG_DFL, signal.SIG_DFL, signal.SIG_IGN]
    assert not marker.exists()


def test_a_terminate_while_the_workers_start_ends_them(tmp_path, monkeypatch):
    """A worker forked with the signals of ``WORKER_SIGNALS`` blocked
    holds a SIGTERM sent while it is still in its initializer (a worker
    forked from a large process can start after the pool's first tasks
    are done) until its dispositions are set, and then ends: the parent's
    handler never runs in it, and terminating the pool does not wait for
    it for ever."""
    from nessai_tpu_torch.utils import multiprocessing as pool_utils

    marker = tmp_path / "handled"
    masks = tmp_path / "masks"
    real = pool_utils.initialise_pool_variables

    def slow_start(model):
        with open(masks, "a") as f:
            f.write(" ".join(str(int(s)) for s in signal.pthread_sigmask(signal.SIG_BLOCK, [])) + "\n")
        time.sleep(1.0)
        real(model)

    def handler(signum, frame):
        marker.write_text(f"{signum} {os.getpid()}")

    monkeypatch.setattr(pool_utils, "initialise_pool_variables", slow_start)
    previous = signal.signal(signal.SIGTERM, handler)
    try:
        model = _host_model()
        model.configure_pool(n_pool=2)
        workers = list(model.pool._pool)
        # in a thread: a worker that outlives the terminate keeps the join
        # waiting, and an alarm may land on another of this process's threads
        closer = threading.Thread(target=model.close_pool, kwargs=dict(code=2), daemon=True)
        closer.start()
        closer.join(30)
        stuck = closer.is_alive()
        for worker in workers:
            worker.kill()
        closer.join(30)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert not stuck, "terminating the pool waited for a worker that ran the parent's handler"
    assert not marker.exists()
    blocked = [set(map(int, line.split())) for line in masks.read_text().splitlines()]
    assert len(blocked) == 2
    assert all({int(s) for s in pool_utils.WORKER_SIGNALS} <= b for b in blocked)
    # the parent's own mask is as it was
    assert not set(pool_utils.WORKER_SIGNALS) & signal.pthread_sigmask(signal.SIG_BLOCK, [])


def test_model_pickle_drops_the_pool():
    model = _host_model()
    with time_limit(60):
        model.configure_pool(n_pool=1)
        restored = pickle.loads(pickle.dumps(model))
        model.close_pool()
    assert restored.pool is None and not restored._pool_configured and restored.n_pool == 1


@pytest.mark.parametrize("chunksize", [1, 7, 100])
def test_likelihood_chunksize_gives_the_batch_values(chunksize):
    model = _host_model()
    model.set_rng(np.random.default_rng(3))
    x = numpy_array_to_live_points(np.random.default_rng(4).normal(size=(50, 2)), model.names)
    batch = model.batch_evaluate_log_likelihood(x)
    model.likelihood_chunksize = chunksize
    np.testing.assert_array_equal(model.batch_evaluate_log_likelihood(x), batch)
    assert model.likelihood_evaluations == 100


def test_sigterm_checkpoints_and_exits_with_130(tmp_path):
    """SIGTERM to a process in a run: the handler writes a checkpoint
    that loads and the process exits with code 130."""
    code = (
        "from nessai_tpu_torch.flowsampler import FlowSampler\n"
        "from nessai_tpu_torch.utils.testing import IntegrationTestModel\n"
        f"fs = FlowSampler(IntegrationTestModel(2), output={str(tmp_path)!r}, nlive=200, seed=2, device='cpu',\n"
        "                 flow_config=dict(n_blocks=2, n_neurons=4, n_layers=1), checkpoint_on_training=True,\n"
        "                 training_config=dict(max_epochs=200, patience=200), plot=False)\n"
        "fs.run(plot=False, save=False)\n"
    )
    resume = tmp_path / "nested_sampler_resume.pkl"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        start = time.monotonic()
        while not resume.exists() and proc.poll() is None and time.monotonic() - start < 120:
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(resume, "rb") as f:
        sampler = pickle.load(f)
    assert sampler.iteration > 0 and sampler.history["checkpoint_iterations"]
