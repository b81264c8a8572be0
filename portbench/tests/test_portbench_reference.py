"""The plain references against the port, on the CPU at small sizes."""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import harness  # noqa: E402
from portbench.reference.evidence import log_evidence, log_evidence_trapezoid, log_volumes  # noqa: E402
from portbench.reference.realnvp import PlainRealNVP  # noqa: E402
from portbench.reference.scan import replay_scan  # noqa: E402


def _trained_like_flow(dim, n_blocks, width, seed):
    """The port's RealNVP with every weight moved off its start (the
    output layers start at zero)."""
    from nessai_tpu_torch.flows.utils import configure_model

    flow = configure_model(dict(n_inputs=dim, n_blocks=n_blocks, n_neurons=width, n_layers=2, seed=seed))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return flow


@pytest.mark.parametrize("dim,n_blocks,width", [(5, 4, 10), (12, 6, 32), (2, 3, 4)])
def test_realnvp_matches_the_port(dim, n_blocks, width):
    flow = _trained_like_flow(dim, n_blocks, width, seed=dim)
    ref = PlainRealNVP(flow.state_dict())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((257, dim)).astype(np.float32)
    with torch.no_grad():
        logp = flow.log_prob(torch.as_tensor(x)).double().numpy()
        x_inv = flow.inverse(torch.as_tensor(x))[0].double().numpy()
    np.testing.assert_allclose(ref.log_prob(x.astype(np.float64)), logp, rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(ref.inverse(x.astype(np.float64))[0], x_inv, rtol=1e-5, atol=2e-5)
    # a round trip through the reference alone is exact to float64
    z, ld = ref.forward(x.astype(np.float64))
    back, ld_inv = ref.inverse(z)
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ld + ld_inv, 0.0, atol=1e-10)


def test_realnvp_rejects_an_unknown_layer():
    with pytest.raises(ValueError):
        PlainRealNVP({"bijector.bijectors.0.weird": np.zeros(3)})


def test_evidence_matches_the_port_integrator():
    from nessai_tpu_torch.evidence import _NSIntegralState

    rng = np.random.default_rng(1)
    nlive = 50
    logL = np.sort(rng.normal(-100, 20, 700))
    state = _NSIntegralState(nlive)
    for v in logL:
        state.increment(v)
    nlives = np.full(logL.size, nlive)
    assert abs(state.logZ - log_evidence(logL, nlives)) < 1e-10
    np.testing.assert_array_equal(np.asarray(state.log_vols[1:]), log_volumes(nlives))
    final = np.sort(rng.normal(-60, 1, nlive))
    final = final[final > logL[-1]]
    for i, v in enumerate(final):
        state.increment(v, nlive=nlive - i)
    state.finalise()
    all_l = np.concatenate([logL, final])
    sched = np.concatenate([nlives, nlive - np.arange(final.size)])
    assert abs(state.logZ - log_evidence_trapezoid(all_l, sched)) < 1e-10


def test_evidence_in_float32_departs():
    logL = np.sort(np.random.default_rng(2).normal(-1800, 30, 5000))
    nlives = np.full(logL.size, 1000)
    gap = abs(log_evidence(logL, nlives, np.float32) - log_evidence(logL, nlives))
    assert gap > 1e-6


@pytest.mark.parametrize("n,k,cap", [(7, 40, 1000), (64, 300, 1000), (64, 300, 17), (1, 5, 3)])
def test_scan_replay_matches_the_port_plain_scan(n, k, cap):
    from nessai_tpu_torch.ops.ns_scan import ns_scan_plain

    rng = np.random.default_rng(n + k)
    live = np.sort(rng.normal(0, 1, n)).astype(np.float32)
    pool = rng.normal(0.5, 1, k).astype(np.float32)
    pool[::7] = live[0]  # ties with the worst point are rejected
    out = ns_scan_plain(torch.as_tensor(live), torch.as_tensor(pool), cap)
    ref = replay_scan(live, pool, cap)
    for got, want in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)
    assert int(out[4]) == ref[4]


@pytest.mark.parametrize("name,module", [("gw_basic", "basic_gw_example"), ("gw_full", "full_gw_example")])
def test_gw_reference_holds_the_port_data_and_likelihood(name, module):
    import importlib

    ex = importlib.import_module(f"nessai_tpu_torch.examples.gw.{module}")
    ref = harness.load_reference(name)
    inj = ref.injection()
    want = dict(freqs=inj["freqs"], data_re=inj["data_re"], data_im=inj["data_im"], inv_psd=1.0 / inj["psd"])
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(ex.LIKELIHOOD_DATA[k], np.float32), v.astype(np.float32))
    model = ex.BasicGWModel() if name == "gw_basic" else ex.FullGWModel()
    rng = np.random.default_rng(3)
    from nessai_tpu_torch.livepoint import empty_structured_array

    pts = empty_structured_array(64, names=model.names)
    for n in model.names:
        lo, hi = model.bounds[n]
        pts[n] = rng.uniform(lo, hi, 64)
    host = model.log_likelihood(pts)
    x = np.stack([pts[n] for n in ref.NAMES], axis=1)
    got = ref.log_likelihood(x)
    np.testing.assert_allclose(got, host, rtol=1e-11, atol=0)
    low = ref.log_likelihood(x, torch.bfloat16)
    assert np.max(np.abs(low - host) / np.abs(host)) > 1e-4
    assert math.isfinite(float(np.sum(got)))
