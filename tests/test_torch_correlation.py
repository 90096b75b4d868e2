"""The port's NumPy copy of the correlation module against the JAX
package's: the same matrices and Cholesky factors, bit for bit, from the
same seed."""

from __future__ import annotations

import numpy as np
import pytest

from dnnpde_tpu.sim import correlation as jax_corr
from dnnpde_tpu_torch.sim import correlation as corr


@pytest.mark.parametrize("kind", corr.CORRELATION_TYPES)
def test_matrices_and_factors_equal_jax(kind):
    assert corr.CORRELATION_TYPES == jax_corr.CORRELATION_TYPES
    C = corr.generate_correlation_matrix(7, kind, seed=3)
    C_ref = jax_corr.generate_correlation_matrix(7, kind, seed=3)
    np.testing.assert_array_equal(C, C_ref)
    np.testing.assert_array_equal(corr.cholesky_factor(C), jax_corr.cholesky_factor(C_ref))
    np.testing.assert_allclose(np.diag(C), 1.0, atol=1e-6)


def test_positive_definite_repair_equals_jax():
    C = np.ones((4, 4)) - 1e-3 * np.eye(4)  # not positive definite
    np.testing.assert_array_equal(corr.make_positive_definite(C), jax_corr.make_positive_definite(C))
    np.linalg.cholesky(corr.make_positive_definite(C))
    with pytest.raises(ValueError, match="correlation_type"):
        corr.generate_correlation_matrix(3, "bogus")
