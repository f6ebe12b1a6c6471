"""AdamW with a global-norm clip and a cosine schedule (the reference's
``repro/optim/adamw.py``), on dicts of tensors.

The update is the reference's formula in the reference's order of
operations, each step rounded where the reference rounds it:

* the global norm in fp32 over every leaf, ``scale = min(1, clip /
  max(||g||, 1e-12))``, and ``g * scale``;
* ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``;
* ``bc1 = 1 - b1 ** step``, ``bc2 = 1 - b2 ** step`` on the fp32 step;
* ``p - lr (mu / bc1 / (sqrt(nu / bc2) + eps) + wd p)`` (``mu`` and
  ``nu`` share ``p``'s dtype, fp32 for the trainer's master state).

``torch.optim.AdamW`` is not this function: it has no global-norm clip
and rounds ``sqrt(v) / sqrt(bc2) + eps`` and the decay in another order.

The update runs in place on the parameters and on ``mu`` / ``nu`` (the
reference donates them) with ``torch._foreach_*`` ops, a few launches for
all leaves together.  The step lives on the host, an int32 0-dim CPU
tensor, so the bias corrections and the schedule cost no device
round trip; the clip scale stays on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-dim, on the CPU
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``lr`` is a float or a schedule ``lr(step) -> 0-dim fp32 tensor``
    evaluated on the incremented step."""

    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Params) -> AdamWState:
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def _lr(self, step: torch.Tensor) -> float:
        lr = self.lr(step) if callable(self.lr) else self.lr
        return float(torch.as_tensor(lr, dtype=torch.float32))

    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Params, AdamWState]:
        """One step: ``params``, ``state.mu`` and ``state.nu`` are updated
        in place (and returned); ``grads`` is left as it is.  Every dict is
        keyed like ``params``."""
        keys = list(params)
        ps = [params[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        g32 = [grads[k].float() for k in keys]
        step = state.step.to("cpu", torch.int32) + 1

        gnorm = torch.sqrt(torch.stack([torch.sum(g * g) for g in g32])
                           .sum())
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        gs = torch._foreach_mul([grads[k] for k in keys], scale)

        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(nu, b2)
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_add_(nu, sq)
        del gs, sq

        s32 = step.to(torch.float32)
        bc1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), s32))
        bc2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), s32))
        lr = self._lr(step)

        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(ps, self.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ps, upd)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; fp32, as the reference's."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
