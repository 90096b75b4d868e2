"""Correlation-matrix generation + positive-definite repair (NumPy only).

A copy of ``dnnpde_tpu/sim/correlation.py`` for the port, which does not
import the JAX package:

- ``no_correlation``          → identity
- ``random_correlation``      → C = AAᵀ normalized to unit diagonal
- ``restricted_random_correlation`` → same with A ← |A| (non-negative corr.)
- PD repair: add εI with doubling ε until Cholesky succeeds.

The random entries come from a NumPy ``seed``; the JAX module's ``key=``
argument has no counterpart here.
"""

from __future__ import annotations

import numpy as np

CORRELATION_TYPES = (
    "no_correlation",
    "random_correlation",
    "restricted_random_correlation",
)


def make_positive_definite(C: np.ndarray, eps: float = 1e-6, max_tries: int = 60) -> np.ndarray:
    """Add εI (doubling ε) until the matrix admits a Cholesky factorization."""
    C = np.asarray(C, dtype=np.float64)
    for _ in range(max_tries):
        try:
            np.linalg.cholesky(C)
            return C
        except np.linalg.LinAlgError:
            C = C + eps * np.eye(C.shape[0])
            eps *= 2.0
    raise np.linalg.LinAlgError("could not repair matrix to positive definite")


def _normalize_to_correlation(C: np.ndarray) -> np.ndarray:
    d = np.sqrt(np.clip(np.diag(C), 1e-12, None))
    C = C / np.outer(d, d)
    np.fill_diagonal(C, 1.0)
    return C


def generate_correlation_matrix(
    dim: int, correlation_type: str = "no_correlation", seed: int | None = None
) -> np.ndarray:
    """Generate a dim×dim correlation matrix by type string, with random
    entries from ``np.random.default_rng(seed)``."""
    if correlation_type == "no_correlation":
        return np.eye(dim)
    if correlation_type not in CORRELATION_TYPES:
        raise ValueError(
            f"Unknown correlation_type {correlation_type!r}; "
            f"expected one of {CORRELATION_TYPES}"
        )
    A = np.random.default_rng(seed).standard_normal((dim, dim))
    if correlation_type == "restricted_random_correlation":
        A = np.abs(A)
    C = _normalize_to_correlation(A @ A.T)
    return make_positive_definite(C)


def cholesky_factor(C: np.ndarray) -> np.ndarray:
    """Lower Cholesky factor of a (repaired) correlation matrix, float32."""
    return np.linalg.cholesky(make_positive_definite(C)).astype(np.float32)
