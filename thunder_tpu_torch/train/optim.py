"""AdamW for the train step: the port's counterpart of ``optax.adamw``.

The JAX package trains with ``optax.adamw(lr)`` (``train_cli.py``), outside
any Pallas kernel.  :func:`adamw` keeps optax's defaults — b1 0.9, b2 0.999,
eps 1e-8, decoupled weight decay 1e-4 on every leaf (torch's own AdamW
default is 1e-2) — and applies them with PyTorch's fused AdamW
(``torch.optim.adamw.adamw(..., fused=True)``): one multi-tensor pass that
updates params and moments in place with float32 math, and no model-sized
temporaries (the ``foreach`` path would allocate a ``sqrt(v)`` the size of
the model).  The state is a plain tree — ``{"step", "mu", "nu"}``, each
shaped like the params, moments in the param dtype as optax keeps them —
so checkpoints save and restore it like the params.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.optim.adamw import adamw as _torch_adamw

from thunder_tpu_torch._tree import tree_leaves, tree_map

__all__ = ["AdamW", "adamw"]


@dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> dict:
        """Zero moments and step counts for every leaf of ``params``."""
        return {
            "step": tree_map(lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
                             params),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        """One AdamW step, in place on ``params`` and ``state``; ``grads``
        is a tree (or leaf list) in the params' leaf order."""
        ps = tree_leaves(params)
        _torch_adamw(
            ps, tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]), [],
            tree_leaves(state["step"]), foreach=False, fused=True, amsgrad=False,
            beta1=self.b1, beta2=self.b2, lr=self.lr, weight_decay=self.weight_decay,
            eps=self.eps, maximize=False)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw(learning_rate)`` with optax's defaults."""
    return AdamW(float(learning_rate), b1, b2, eps, weight_decay)
