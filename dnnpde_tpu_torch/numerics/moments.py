"""Central-moment (moment-matching) basket pricer, the counterpart of
``dnnpde_tpu/numerics/moments.py``: the first moments of the arithmetic
basket at T with correlations, a matched lognormal, and a Black–Scholes-type
price on it. Host-side float64 in NumPy and SciPy, as in the reference; no
device is involved.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def basket_moments(S0, sigma, T: float, r: float, corr: Optional[np.ndarray] = None,
                   weights: Optional[np.ndarray] = None) -> tuple[float, float, float]:
    """First three raw moments of B_T = Σ wᵢ S_T,i for correlated GBMs:
    m1 = Σ wᵢFᵢ, m2 = Σᵢⱼ wᵢwⱼFᵢFⱼ e^{σᵢσⱼρᵢⱼT},
    m3 = Σᵢⱼₖ wᵢwⱼwₖFᵢFⱼFₖ e^{(σᵢσⱼρᵢⱼ+σᵢσₖρᵢₖ+σⱼσₖρⱼₖ)T}, Fᵢ = S⁰ᵢe^{rT}."""
    S0 = np.atleast_1d(np.asarray(S0, np.float64))
    D = S0.shape[0]
    w = np.full(D, 1.0 / D) if weights is None else np.asarray(weights, np.float64)
    sig = np.broadcast_to(np.asarray(sigma, np.float64), (D,))
    C = np.eye(D) if corr is None else np.asarray(corr, np.float64)
    wF = w * S0 * np.exp(r * T)
    cross = np.outer(sig, sig) * C * T  # σᵢσⱼρᵢⱼT
    m1 = float(wF.sum())
    m2 = float(np.einsum("i,j,ij->", wF, wF, np.exp(cross)))
    e3 = cross[:, :, None] + cross[:, None, :] + cross[None, :, :]
    m3 = float(np.einsum("i,j,k,ijk->", wF, wF, wF, np.exp(e3)))
    return m1, m2, m3


def match_lognormal(m1: float, m2: float) -> tuple[float, float]:
    """Two-moment lognormal match B_T ~ LN(μ, s²): μ = 2 ln m1 − ½ ln m2,
    s² = ln m2 − 2 ln m1 (floored at 1e-12)."""
    mu = 2.0 * np.log(m1) - 0.5 * np.log(m2)
    s2 = np.log(m2) - 2.0 * np.log(m1)
    return float(mu), float(max(s2, 1e-12))


def moment_matched_basket_call(S0, K: float, T: float, r: float, sigma,
                               corr: Optional[np.ndarray] = None,
                               weights: Optional[np.ndarray] = None) -> float:
    """E[e^{−rT}(B_T − K)⁺] under the matched lognormal:
    e^{−rT}(e^{μ+s²/2}Φ(d1) − KΦ(d2))."""
    from scipy.stats import norm  # imported here: scipy.stats takes seconds to load

    m1, m2, _ = basket_moments(S0, sigma, T, r, corr, weights)
    mu, s2 = match_lognormal(m1, m2)
    s = np.sqrt(s2)
    d1 = (mu + s2 - np.log(K)) / s
    d2 = d1 - s
    return float(np.exp(-r * T) * (np.exp(mu + 0.5 * s2) * norm.cdf(d1) - K * norm.cdf(d2)))
