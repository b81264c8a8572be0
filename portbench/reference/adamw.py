"""Training steps of a RealNVP replayed with a plain AdamW.

Written from the published descriptions: Adam (Kingma & Ba,
arXiv:1412.6980) with its bias corrections, the weight decay decoupled
from the gradient as in AdamW (Loshchilov & Hutter, arXiv:1711.05101),
``p <- p - lr wd p`` before the moment update, and the gradients clipped
by their global norm first (``g <- g max_norm / |g|`` where ``|g|`` is
at least ``max_norm``). The loss is the mean negative log-density of the
batch, or with weights ``-sum(w log q) / max(sum(w), 1e-12)``.

The replay starts from recorded weights and moments and takes recorded
batches, so it follows the program from its own state; it computes
every step itself, in ``dtype``.
"""

import numpy as np
import torch

from .realnvp import PlainRealNVP

__all__ = ["replay_steps"]


def _clip(grads, max_norm):
    if not max_norm:
        return grads
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = 1.0 if float(norm) < max_norm else max_norm / norm
    return {k: g * scale for k, g in grads.items()}


def replay_steps(state, before, moments, batches, config, dtype=torch.float64, device="cpu"):
    """Replay ``len(batches)`` AdamW steps.

    ``state`` is the flow's state dict (for its structure and buffers),
    ``before`` its trainable weights by name, ``moments`` each weight's
    ``(first moment, second moment, step count)`` before the first step,
    ``batches`` a list of ``(x, weights or None)``, ``config`` the
    training configuration (``lr``, ``betas``, ``eps``, ``weight_decay``,
    ``clip_grad_norm``). Returns ``dict(losses, grad, after)``: the loss
    of each step, the clipped gradient of the first step and the weights
    after the last, as float64 numpy arrays by name."""
    flow = PlainRealNVP(state, dtype, device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=flow.device).to(dtype)  # noqa: E731
    w = dict(flow.tensors)
    names = [k for k in before if k in w]
    if len(names) != len(before):
        raise ValueError(f"weights the reference flow does not have: {sorted(set(before) - set(w))}")
    p = {k: t(before[k]) for k in names}
    m = {k: t(moments[k][0]) for k in names}
    v = {k: t(moments[k][1]) for k in names}
    step = {k: int(moments[k][2]) for k in names}
    lr, (b1, b2), eps, wd = config["lr"], config["betas"], config["eps"], config["weight_decay"]
    losses, first_grad = [], None
    for x, weights in batches:
        leaves = {k: p[k].detach().requires_grad_(True) for k in names}
        log_q = flow.log_prob_t(t(x), dict(w, **leaves))
        if weights is None:
            loss = -log_q.mean()
        else:
            wt = t(weights)
            loss = -(wt * log_q).sum() / wt.sum().clamp_min(1e-12)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        grads = _clip(grads, config.get("clip_grad_norm"))
        if first_grad is None:
            first_grad = {k: g.double().cpu().numpy() for k, g in grads.items()}
        losses.append(float(loss.detach().double()))
        with torch.no_grad():
            for k in names:
                g = grads[k]
                step[k] += 1
                q = p[k] * (1.0 - lr * wd)
                m[k] = b1 * m[k] + (1.0 - b1) * g
                v[k] = b2 * v[k] + (1.0 - b2) * g * g
                m_hat = m[k] / (1.0 - b1 ** step[k])
                v_hat = v[k] / (1.0 - b2 ** step[k])
                p[k] = q - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return dict(losses=losses, grad=first_grad, after={k: p[k].double().cpu().numpy() for k in names})
