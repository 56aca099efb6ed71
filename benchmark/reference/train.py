"""Plain reference of one MaskGit training step (f32, autograd, no
kernels): the masked-token cross entropy of `MaskGit.forward` under given
draws, and optax's Adam.

Loss: each row masks max(round(n cos(t pi / 2)), 1) positions, those of the
lowest uniform scores; the masked positions take the mask id and are the
labels. With self-conditioning, when the step's coin is below the
probability, a forward without dropout and without a gradient gives the
embeddings that the main forward adds through its feed-forward (zeros
otherwise). The main forward drops a row's text where its uniform is below
the dropout probability. The loss is the mean of logsumexp - picked logit
over the labels. The exponential moving average starts as a copy of the
parameters after the first step and then takes `ema beta + params (1 -
beta)` after each.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import trunk as ref_trunk
from benchmark.reference.precision import linear

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss(w: Dict[str, torch.Tensor], t: dict, m: dict, ids, text, text_mask, draws: dict, mode: str = "f32"):
    b, n = ids.shape
    mask_id = t["num_tokens"]
    count = torch.round(n * torch.cos(draws["rand_time"] * math.pi * 0.5)).clamp(min=1)
    ranks = torch.argsort(torch.argsort(draws["mask_scores"], dim=-1, stable=True), dim=-1, stable=True)
    masked = ranks < count.reshape(-1, 1)
    x = torch.where(masked, torch.full_like(ids, mask_id), ids)
    ctx = ref_trunk.context(w, text, None, mode)
    self_cond = torch.zeros(b, n, t["dim"], device=ids.device)
    if t["self_cond"] and float(draws["self_cond_u"]) < m["self_cond_prob"]:
        with torch.no_grad():
            self_cond = ref_trunk.trunk(w, t, x, ctx, text_mask, self_cond, mode)
    keep = draws["keep_u"].reshape(b, 1) >= m["cond_drop_prob"]
    emb = ref_trunk.trunk(w, t, x, ctx, text_mask & keep, self_cond, mode)
    logits = linear(emb, w["to_logits.weight"], mode)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, ids[..., None])[..., 0]
    return ((lse - picked) * masked).sum() / masked.sum().clamp(min=1)


class Adam:
    """optax.adam at a constant rate, in f32."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.count = params, lr, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        bc1, bc2 = 1.0 - B1**self.count, 1.0 - B2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).add_(g * g, alpha=1 - B2)
            p.add_((mu / bc1) / ((nu / bc2).sqrt() + EPS), alpha=-self.lr)


def follow(w: Dict[str, torch.Tensor], t: dict, m: dict, batches: List[dict], lr: float, ema_beta: float,
           mode: str = "f32"):
    """Train `w` (copied) over `batches` (ids, text, text_mask, draws).
    Returns the losses, the first step's gradients, the parameters' change
    and the moving average's change after the last step, and the moving
    average's change had it stopped after its first copy, by leaf name."""
    names = list(w)
    params = [w[k].detach().clone().requires_grad_(True) for k in names]
    start = [p.detach().clone() for p in params]
    opt = Adam(params, lr)
    losses, first, ema, frozen = [], None, None, None
    for bt in batches:
        value = loss(dict(zip(names, params)), t, m, bt["ids"], bt["text"], bt["text_mask"], bt["draws"], mode)
        grads = torch.autograd.grad(value, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if first is None:
            first = dict(zip(names, [g.detach() for g in grads]))
        opt.step(grads)
        with torch.no_grad():
            if ema is None:
                ema = [p.detach().clone() for p in params]
                frozen = [e.clone() for e in ema]
            else:
                for e, p in zip(ema, params):
                    e.mul_(ema_beta).add_(p.detach(), alpha=1.0 - ema_beta)
        losses.append(float(value.detach()))
    change = {k: (p.detach() - s) for k, p, s in zip(names, params, start)}
    ema_change = {k: (e - s) for k, e, s in zip(names, ema, start)}
    frozen_change = {k: (e - s) for k, e, s in zip(names, frozen, start)}
    return losses, first, change, ema_change, frozen_change
