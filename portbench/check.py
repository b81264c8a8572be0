"""Whether what the window produced is correct: the comparisons with the
plain reference, and the control readings that the limits are set from.

Each number is a gap between what the program produced in the window and
what the reference computes from the same inputs:

- ``flow_logp_gap``: the largest ``|log q|`` gap, in nats, of the flow as
  trained at the window's end (the program's flow through the coupling
  kernel, float32) against a float64 RealNVP built from its weights, on
  the live points in the flow's space;
- ``flow_inverse_gap``: the largest gap of the inverse at unit-Gaussian
  draws from the seed, over ``1 + |x|`` of the reference's;
- ``likelihood_gap``: the largest gap of a committed point's
  log-likelihood (the program's device likelihood, float32) against the
  configuration's float64 reference, over ``max(1, |log L|)``; a sample
  from the seed of the points committed in the window;
- ``logz_gap`` and ``logw_gap``: the evidence and the log prior volumes
  of each run of the window, from its whole sequence of dead points,
  against the float64 recursion;
- ``ordering_mismatches``: the order in which points were consumed and
  inserted, against a replay of the same pool against the same live set:
  the entries of the consume/insert scans' outputs (accept mask, consumed
  ids, insertion indices where accepted, final live ids, count) that
  differ, and, of the host passes that consume a pool where no scan was
  chained on, the dead points and insertion indices that differ; a sample
  from the seed of the window's scans and passes;
- ``data_bits``: the entries of the model's likelihood data that differ,
  bit for bit, from the float32 cast of the reference's injection;
- ``train_loss_gap``, ``train_grad_gap`` and ``train_change_gap``: one
  training of the window, drawn from the seed, whose first three
  optimiser steps are replayed by a plain float64 AdamW
  (:mod:`.reference.adamw`) from the weights, moments and batches the
  program had: the largest gap of a step's loss, over ``max(1, |loss|)``;
  of the norm of the first step's gradient as the optimiser got it (worked out from its
  moments after the step), leaf by leaf; and of the norm of each leaf's
  change over the three steps. A leaf's gap is over the reference's norm
  of that leaf or of the median leaf, whichever is larger; leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone and are left out;
- ``populate_flips`` and ``populate_x_gap``: a few first rounds of the
  device populate loop's calls in the window, drawn from the seed,
  replayed from the round's generator state through the float64 flow,
  the reparameterisations' inverses and the prior
  (:mod:`.reference.populate`): the draws that one side accepted and the
  other did not, and the largest gap of an accepted row.

:func:`snapshot` takes what the program produced, once the window has
closed, so that the program can be freed before the reference runs.

The control puts the reference, one precision below the configuration's,
in the program's place: the flow, its training steps and the populate
rounds in float32 with TF32 matmuls on the card (bfloat16 off it), the
likelihood, the scan's comparisons and the data in bfloat16, the
evidence recursion in float32.
"""

import contextlib

import numpy as np
import torch

from .reference.adamw import replay_steps
from .reference.evidence import log_evidence, log_evidence_trapezoid, log_volumes
from .reference.populate import replay_round, round_diff
from .reference.realnvp import PlainRealNVP
from .reference.scan import replay_scan

__all__ = ["NUMBERS", "snapshot", "program_readings", "control_readings", "judge"]

#: the numbers compared, in the order the limits files give them
NUMBERS = (
    "flow_logp_gap",
    "flow_inverse_gap",
    "likelihood_gap",
    "logz_gap",
    "logw_gap",
    "ordering_mismatches",
    "data_bits",
    "train_loss_gap",
    "train_grad_gap",
    "train_change_gap",
    "populate_flips",
    "populate_x_gap",
)


def _max(a):
    a = np.asarray(a, np.float64)
    if a.size == 0:
        return 0.0
    if not np.all(np.isfinite(a)):
        return float("inf")
    return float(np.max(a))


def _rng(seed, k):
    return np.random.default_rng(np.random.SeedSequence([int(seed), 9173, k]))


def _flow_segment(segments):
    """The latest run of the window with a trained flow."""
    for fs, _, _ in reversed(segments):
        if getattr(fs.ns._flow_proposal, "flow", None) is not None and getattr(fs.ns, "train_count", 0) > 0:
            return fs
    return None


def _committed_points(segments, names, rng, n_max):
    """A sample from the seed of the points each run committed in the
    window (its dead points from the iteration it started at), as
    ``(parameters [n, len(names)], logL [n])``."""
    rows = []
    for fs, it0, _ in segments:
        samples = fs.ns.nested_samples[it0:]
        if len(samples):
            arr = np.asarray(samples)
            rows.append(np.stack([arr[n] for n in names] + [arr["logL"]], axis=1).astype(np.float64))
    if not rows:
        return np.zeros((0, len(names))), np.zeros(0)
    rows = np.concatenate(rows)
    if len(rows) > n_max:
        rows = rows[np.sort(rng.choice(len(rows), n_max, replace=False))]
    return rows[:, :-1], rows[:, -1]


def _host(a):
    return a.detach().double().cpu().numpy()


def _host_training(tr):
    return dict(
        state={k: v.cpu() for k, v in tr["state"].items()},
        before={k: _host(v) for k, v in tr["before"].items()},
        moments={k: (_host(m), _host(v), s) for k, (m, v, s) in tr["moments"].items()},
        moments1={k: (_host(m), _host(v), s) for k, (m, v, s) in tr["moments1"].items()},
        steps=[(_host(x), None if w is None else _host(w), float(loss)) for x, w, loss in tr["steps"]],
        after={k: _host(v) for k, v in tr["after"].items()},
    )


def _host_round(item):
    count = int(item["count"])
    out = {k: v for k, v in item.items() if k not in ("buf", "count", "state")}
    out["state"] = {k: v.cpu() for k, v in item["state"].items()}
    out["rows"] = _host(item["buf"][: min(count, item["cap"])])
    out["count"] = count
    return out


def snapshot(segments, scans, passes, names, seed, training=None, rounds=(), n_points=4096, n_scans=8):
    """What the program produced in the window, as host arrays: the flow's
    weights and its outputs on the check's inputs, a sample of the
    committed points, each run's dead points and evidence state, a sample
    of the scans, the model's likelihood data, the training kept and the
    populate rounds kept."""
    from nessai_tpu_torch.livepoint import live_points_to_array

    snap = dict(seed=int(seed))
    fs = _flow_segment(segments)
    if fs is not None:
        proposal = fs.ns._flow_proposal
        fm = proposal.flow
        x_prime, _ = proposal.rescale(fs.ns.live_points)
        x = live_points_to_array(x_prime, proposal.prime_parameters).astype(np.float32).astype(np.float64)
        z = _rng(seed, 0).standard_normal(x.shape).astype(np.float32).astype(np.float64)
        snap["flow"] = dict(
            state={k: v.detach().cpu() for k, v in fm.flow.state_dict().items()},
            x=x,
            z=z,
            logp=fm.forward_and_log_prob(x)[1],
            x_inv=fm.inverse_and_log_prob(z)[0],
        )
    snap["points"], snap["logL"] = _committed_points(segments, names, _rng(seed, 1), n_points)
    runs = []
    for seg, _, _ in segments:
        ns = seg.ns
        logL = np.asarray([float(s["logL"]) for s in ns.nested_samples], np.float64)
        n, nlive = logL.size, int(ns.nlive)
        if ns.finalised:
            nlives = np.concatenate([np.full(max(n - nlive, 0), nlive), np.arange(nlive, 0, -1)[:n]])
        else:
            nlives = np.full(n, nlive)
        runs.append(
            dict(
                logL=logL,
                nlives=nlives,
                finalised=bool(ns.finalised),
                logZ=float(ns.state.logZ),
                log_vols=np.asarray(ns.state.log_vols[1:], np.float64),
            )
        )
    snap["runs"] = runs
    rng = _rng(seed, 2)
    picked = scans if len(scans) <= n_scans else [scans[i] for i in sorted(rng.choice(len(scans), n_scans, replace=False))]
    snap["scans"] = [
        (
            live.double().cpu().numpy(),
            pool.double().cpu().numpy(),
            max_accepts,
            [np.asarray(o.cpu().numpy() if hasattr(o, "cpu") else o).astype(np.int64).ravel() for o in out],
        )
        for live, pool, max_accepts, out in picked
    ]
    rng = _rng(seed, 3)
    snap["passes"] = passes if len(passes) <= n_scans else [passes[i] for i in sorted(rng.choice(len(passes), n_scans, replace=False))]
    snap["data"] = _model_data(segments[-1][0].ns.model)
    snap["training"] = None if training is None else _host_training(training)
    snap["rounds"] = [_host_round(r) for r in rounds]
    return snap


def _model_data(model):
    data = model.torch_likelihood_data
    return {k: np.asarray(data[k].cpu().numpy() if hasattr(data[k], "cpu") else data[k], np.float32) for k in data}


def _evidence(run, dtype):
    if run["finalised"]:
        return log_evidence_trapezoid(run["logL"], run["nlives"], dtype)
    return log_evidence(run["logL"], run["nlives"], dtype)


def _scan_diff(outputs, ref):
    """Entries of a scan's outputs that differ from the replay's; the
    insertion indices count where the replay accepted."""
    refs = [np.asarray(r).astype(np.int64).ravel() for r in ref]
    keep = refs[0].astype(bool)
    bad = 0
    for i, (p, r) in enumerate(zip(outputs, refs)):
        p = np.asarray(p).astype(np.int64).ravel()
        if p.shape != r.shape:
            bad += max(p.size, r.size)
            continue
        if i == 2:
            p, r = p[keep], r[keep]
        bad += int(np.count_nonzero(p != r))
    return bad


def _pass_diff(live, pool, dead, ins, dtype="float64"):
    """Dead points and insertion indices of a host pass that differ from
    the replay's first accepts (a pass may stop before the pool's end)."""
    mask, consumed, ref_ins, _, _ = replay_scan(live, pool, len(pool) + 1, dtype)
    values = np.concatenate([live, pool])
    ref_dead = values[consumed[mask]]
    ref_ins = ref_ins[mask]
    m = min(len(dead), len(ref_dead))
    return (
        int(np.count_nonzero(np.asarray(dead[:m]) != ref_dead[:m]))
        + int(np.count_nonzero(np.asarray(ins[:m]) != ref_ins[:m]))
        + abs(len(dead) - m)
    )


def _injection_f32(reference, dtype=None):
    inj = reference.injection()
    want = dict(freqs=inj["freqs"], data_re=inj["data_re"], data_im=inj["data_im"], inv_psd=1.0 / inj["psd"])
    if dtype is None:
        return {k: v.astype(np.float32) for k, v in want.items()}
    return {k: torch.as_tensor(v).to(dtype).float().numpy() for k, v in want.items()}


def _data_bits(data, want):
    bad = 0
    for k, ref in want.items():
        got = np.asarray(data.get(k, np.zeros(0)), np.float32)
        bad += ref.size if got.shape != ref.shape else int(np.count_nonzero(got.view(np.int32) != ref.view(np.int32)))
    return bad


@contextlib.contextmanager
def _low_precision(device):
    """The control's precision below float32: TF32 matmuls on the card,
    bfloat16 elsewhere (the dtype it yields)."""
    if torch.device(device).type != "cuda":
        yield torch.bfloat16
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _leaf_norms(arrays):
    return {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in arrays.items()}


def _worst_leaf(got, ref, keep):
    """The largest ``|got - ref|`` over ``max(ref, median of ref)``, over
    the leaves ``keep``."""
    if not keep:
        return float("inf")
    med = float(np.median([ref[k] for k in keep]))
    return _max([abs(got[k] - ref[k]) / max(ref[k], med, 1e-300) for k in keep])


def _training_numbers(tr, training_config, got, device):
    """The training numbers of ``got`` (``dict(losses, grad, after)``)
    against the float64 replay of the steps in ``tr``."""
    batches = [(x, w) for x, w, _ in tr["steps"]]
    ref = replay_steps(tr["state"], tr["before"], tr["moments"], batches, training_config, torch.float64, device)
    g_ref = _leaf_norms(ref["grad"])
    med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    before = tr["before"]
    change = lambda after: _leaf_norms({k: after[k] - before[k] for k in ref["after"]})  # noqa: E731
    return dict(
        # over |loss|: a flow far from the live points it is trained on
        # starts at losses of hundreds of nats
        train_loss_gap=_max(
            np.abs(np.asarray(got["losses"]) - ref["losses"]) / np.maximum(1.0, np.abs(ref["losses"]))
        ),
        train_grad_gap=_worst_leaf(_leaf_norms(got["grad"]), g_ref, keep),
        train_change_gap=_worst_leaf(change(got["after"]), change(ref["after"]), keep),
    )


def _program_training(tr, training_config):
    """The program's losses, first gradient (from its moments before and
    after the first step) and weights after the last step."""
    b1 = training_config["betas"][0]
    grad = {k: (tr["moments1"][k][0] - b1 * tr["moments"][k][0]) / (1.0 - b1) for k in tr["moments"]}
    return dict(losses=[loss for _, _, loss in tr["steps"]], grad=grad, after=tr["after"])


def _round_numbers(rounds, reference, device, low=None):
    """``populate_flips`` and ``populate_x_gap`` of the rounds, the
    program's rows or, with ``low`` (a dtype), the reference's in that
    dtype in their place."""
    flips, gap = 0, 0.0
    for item in rounds:
        x_ref, acc_ref = replay_round(item, PlainRealNVP(item["state"], torch.float64, device), reference.KINDS, reference.BOUNDS, torch.float64, device)
        if low is None:
            rows, count = item["rows"], item["count"]
        else:
            x_low, acc_low = replay_round(item, PlainRealNVP(item["state"], low, device), reference.KINDS, reference.BOUNDS, low, device)
            rows, count = x_low[acc_low][: item["cap"]], int(acc_low.sum())
        f, g = round_diff(rows, count, item["cap"], x_ref, acc_ref, item["parameters"], reference.BOUNDS)
        flips, gap = flips + f, max(gap, g)
    return dict(populate_flips=flips, populate_x_gap=gap) if rounds else {}


def program_readings(snap, reference, device="cuda", training_config=None):
    """The numbers of the program's window against the reference."""
    out = {}
    tr = snap.get("training")
    if tr is not None:
        out.update(_training_numbers(tr, training_config, _program_training(tr, training_config), device))
    out.update(_round_numbers(snap.get("rounds", ()), reference, device))
    flow = snap.get("flow")
    if flow is not None:
        ref = PlainRealNVP(flow["state"], torch.float64, device)
        x_ref = ref.inverse(flow["z"])[0]
        out["flow_logp_gap"] = _max(np.abs(flow["logp"] - ref.log_prob(flow["x"])))
        out["flow_inverse_gap"] = _max(np.abs(flow["x_inv"] - x_ref) / (1.0 + np.abs(x_ref)))
    ref_logL = reference.log_likelihood(snap["points"], torch.float64, device)
    out["likelihood_gap"] = _max(np.abs(snap["logL"] - ref_logL) / np.maximum(1.0, np.abs(ref_logL)))
    out["logz_gap"] = _max([abs(r["logZ"] - _evidence(r, np.float64)) for r in snap["runs"]])
    out["logw_gap"] = _max(
        [
            _max(np.abs(r["log_vols"] - log_volumes(r["nlives"]))) if r["log_vols"].shape == r["nlives"].shape else np.inf
            for r in snap["runs"]
        ]
    )
    out["ordering_mismatches"] = sum(_scan_diff(s[3], replay_scan(s[0], s[1], s[2])) for s in snap["scans"]) + sum(
        _pass_diff(*p) for p in snap["passes"]
    )
    out["data_bits"] = _data_bits(snap["data"], _injection_f32(reference))
    return out


def control_readings(snap, reference, device="cuda", training_config=None):
    """The same numbers with the reference, one precision lower, in the
    program's place."""
    out = {}
    tr = snap.get("training")
    with _low_precision(device) as low:
        if tr is not None:
            batches = [(x, w) for x, w, _ in tr["steps"]]
            got = replay_steps(tr["state"], tr["before"], tr["moments"], batches, training_config, low, device)
            out.update(_training_numbers(tr, training_config, got, device))
        out.update(_round_numbers(snap.get("rounds", ()), reference, device, low))
    flow = snap.get("flow")
    if flow is not None:
        ref = PlainRealNVP(flow["state"], torch.float64, device)
        if torch.device(device).type == "cuda":
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                low = PlainRealNVP(flow["state"], torch.float32, device)
                logp_low, x_low = low.log_prob(flow["x"]), low.inverse(flow["z"])[0]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
        else:
            low = PlainRealNVP(flow["state"], torch.bfloat16, device)
            logp_low, x_low = low.log_prob(flow["x"]), low.inverse(flow["z"])[0]
        x_ref = ref.inverse(flow["z"])[0]
        out["flow_logp_gap"] = _max(np.abs(logp_low - ref.log_prob(flow["x"])))
        out["flow_inverse_gap"] = _max(np.abs(x_low - x_ref) / (1.0 + np.abs(x_ref)))
    ref_logL = reference.log_likelihood(snap["points"], torch.float64, device)
    low_logL = reference.log_likelihood(snap["points"], torch.bfloat16, device)
    out["likelihood_gap"] = _max(np.abs(low_logL - ref_logL) / np.maximum(1.0, np.abs(ref_logL)))
    out["logz_gap"] = _max([abs(_evidence(r, np.float32) - _evidence(r, np.float64)) for r in snap["runs"]])
    out["logw_gap"] = _max(
        [_max(np.abs(log_volumes(r["nlives"], np.float32) - log_volumes(r["nlives"]))) for r in snap["runs"]]
    )
    low = []
    for live, pool, _, _ in snap["passes"]:
        mask, consumed, ins, _, _ = replay_scan(live, pool, len(pool) + 1, "bfloat16")
        low.append((live, pool, np.concatenate([live, pool])[consumed[mask]], ins[mask]))
    out["ordering_mismatches"] = sum(
        _scan_diff(replay_scan(s[0], s[1], s[2], "bfloat16"), replay_scan(s[0], s[1], s[2])) for s in snap["scans"]
    ) + sum(_pass_diff(*p) for p in low)
    out["data_bits"] = _data_bits(_injection_f32(reference, torch.bfloat16), _injection_f32(reference))
    return out


def judge(readings, limits):
    """``(correct, checks)``: each number of the cell's limits beside its
    limit, in their order; a number with no reading is not correct."""
    checks = {}
    correct = True
    for name in limits:
        value = readings.get(name)
        limit = limits.get(name)
        ok = value is not None and limit is not None and value <= limit
        correct = correct and ok
        checks[name] = dict(value=value, limit=limit)
    return correct, checks
