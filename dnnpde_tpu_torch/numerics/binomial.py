"""Cox–Ross–Rubinstein binomial tree: the early-exercise oracle, the
counterpart of ``dnnpde_tpu/numerics/binomial.py`` (numpy on the host there
too, so it is the same code).

European, American and Bermudan exercise (``exercise_every``: exercise
only every k-th tree step), so the solver's Bermudan-N value can be scored
against the matching discrete oracle rather than the continuum American
price.
"""

from __future__ import annotations

import numpy as np

__all__ = ["crr_binomial"]


def crr_binomial(
    S0: float,
    K: float,
    T: float,
    r: float,
    sigma: float,
    n_steps: int = 2000,
    payoff: str = "put",
    american: bool = True,
    exercise_every: int = 1,
    q: float = 0.0,
) -> float:
    """CRR binomial price of a vanilla option with optional early exercise.

    Args:
      S0, K, T, r, sigma: spot, strike, maturity, rate, volatility.
      q: continuous dividend yield (shifts the risk-neutral drift to
        r − q; discounting stays at r). Makes early exercise of a CALL
        optimal when q > 0 — the 1-asset degenerate case of the Bermudan
        max-call benchmark (δ=10%) prices against this tree.
      n_steps: tree depth (price error is O(1/n) with the usual even/odd
        oscillation; 2000 is ≲ 1e-4 relative for ATM vanillas).
      payoff: "put" | "call".
      american: False → European (no exercise before T regardless of
        ``exercise_every``).
      exercise_every: allow exercise only at tree steps that are multiples
        of this (counting from the root, which always takes the immediate-
        exercise max — matching ``PDEProblem.value_u``'s read-time Snell
        max). ``n_steps // N`` with ``N`` solver time-steps prices the
        Bermudan-N contract the deep solver actually learns.

    Returns the root value as a python float.
    """
    if payoff not in ("put", "call"):
        raise ValueError(f"payoff must be 'put' or 'call', got {payoff!r}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    dt = T / n_steps
    u = float(np.exp(sigma * np.sqrt(dt)))
    d = 1.0 / u
    disc = float(np.exp(-r * dt))
    p = (np.exp((r - q) * dt) - d) / (u - d)
    if not (0.0 < p < 1.0):
        raise ValueError(
            f"risk-neutral up-probability {p:.4f} outside (0, 1): "
            "increase n_steps (needs sigma*sqrt(dt) > r*dt)"
        )

    def intrinsic(S: np.ndarray) -> np.ndarray:
        return (np.maximum(K - S, 0.0) if payoff == "put"
                else np.maximum(S - K, 0.0))

    j = np.arange(n_steps + 1, dtype=np.float64)
    S = S0 * u ** j * d ** (n_steps - j)
    V = intrinsic(S)
    for i in range(n_steps - 1, -1, -1):
        V = disc * (p * V[1:] + (1.0 - p) * V[:-1])
        if american and i % exercise_every == 0:
            j = np.arange(i + 1, dtype=np.float64)
            V = np.maximum(V, intrinsic(S0 * u ** j * d ** (i - j)))
    return float(V[0])
