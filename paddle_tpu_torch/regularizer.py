"""Weight regularizers (port of ``paddle_tpu/regularizer.py``).

The optimizer reads them through its ``weight_decay`` argument:
``L2Decay`` adds ``coeff * param`` to the gradient (or decays decoupled
in ``AdamW``), ``L1Decay`` adds ``coeff * sign(param)``.
"""

from __future__ import annotations

import torch


class L2Decay:
    """``loss += 0.5 * coeff * ||w||^2``, i.e. ``grad += coeff * w``."""

    mode = "l2"

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def grad_term(self, param: torch.Tensor) -> torch.Tensor:
        return self._coeff * param

    def __repr__(self):
        return f"L2Decay(coeff={self._coeff})"


class L1Decay:
    """``loss += coeff * ||w||_1``, i.e. ``grad += coeff * sign(w)``."""

    mode = "l1"

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def grad_term(self, param: torch.Tensor) -> torch.Tensor:
        return self._coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay(coeff={self._coeff})"
