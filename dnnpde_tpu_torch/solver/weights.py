"""Per-path residual weighting for the X0-cloud (surface) mode, the
counterpart of ``dnnpde_tpu/solver/weights.py``.

``SolverConfig.path_weight_fn`` multiplies each path's contribution to the
BSDE residuals and terminal penalties. The policy below weights squared
price residuals by 1/vega², so that each path has the same influence in
implied-vol space (a price error δC reads as δIV = δC / vega).
"""

from __future__ import annotations

import torch

from dnnpde_tpu_torch.numerics.implied_vol import bs_vega

Tensor = torch.Tensor


def iv_space_weights(
    strike: float = 1.0,
    T: float = 1.0,
    r: float = 0.0,
    vega_floor: float = 0.1,
):
    """Weights ∝ 1/vega(S0, v0)², normalized to mean 1 over the batch (a
    reduction on the device).

    For 2-factor (S, v) states the BS vega is evaluated at σ = √v; for
    1-factor states at a 20 % proxy vol. ``vega_floor`` caps the deep-wing
    weights.
    """

    def weight(X0: Tensor) -> Tensor:
        S = X0[..., 0]
        if X0.shape[-1] > 1:
            sig = torch.sqrt(torch.clamp(X0[..., 1], min=1e-6))
        else:
            sig = torch.full_like(S, 0.2)
        vega = bs_vega(S, strike, T, r, sig)
        w = 1.0 / torch.clamp(vega, min=vega_floor) ** 2
        return w / torch.mean(w)

    return weight
