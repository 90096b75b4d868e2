"""Prediction sampling, the counterpart of ``dnnpde_tpu/evals/predictions.py``.

Draws ``num_samples`` fresh Brownian minibatches, runs the trained model on
each and concatenates along the batch axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

def _sample_seed(seed: int, i: int) -> int:
    """The seed of sample i: the first 63 bits of
    ``np.random.SeedSequence([seed, i])``'s first uint64 word."""
    word = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]
    return int(word) & (2**63 - 1)


@dataclasses.dataclass
class PredictionResult:
    t_test: np.ndarray  # (num_samples·M, N+1, 1)
    W_test: np.ndarray  # (M, N+1, D): the last drawn batch
    X_pred: np.ndarray  # (num_samples·M, N+1, D)
    Y_pred: np.ndarray  # (num_samples·M, N+1, 1)


class PredictionGenerator:
    """``generate_predictions() → PredictionResult(t, W, X, Y)``.

    Seeding rule (in place of JAX's ``fold_in(PRNGKey(seed), i)``): sample i
    draws its minibatch from ``torch.Generator(device=trainer.device)``
    seeded with :func:`_sample_seed` (seed, i), so each sample depends only on
    (``seed``, i). ``use_ema=True`` runs the Polyak/EMA shadow
    (``Trainer(ema_decay=...)``) instead of the raw last iterate.
    """

    def __init__(self, trainer, Xi=None, num_samples: int = 16, seed: int = 37,
                 use_ema: bool = False):
        self.trainer = trainer
        self.use_ema = use_ema
        Xi = trainer.problem.x0 if Xi is None else Xi
        self.Xi = torch.as_tensor(Xi, dtype=torch.float32).reshape(-1, trainer.problem.dim)
        self.num_samples = num_samples
        self.seed = seed

    def generate_predictions(self) -> PredictionResult:
        ts, Xs, Ys = [], [], []
        W_last = None
        for i in range(self.num_samples):
            gen = torch.Generator(device=self.trainer.device).manual_seed(_sample_seed(self.seed, i))
            t, W = self.trainer.fetch_minibatch(generator=gen)
            X_pred, Y_pred = self.trainer.predict(self.Xi, t, W, use_ema=self.use_ema)
            ts.append(t.cpu().numpy())
            Xs.append(X_pred)
            Ys.append(Y_pred)
            W_last = W.cpu().numpy()
        return PredictionResult(
            t_test=np.concatenate(ts, axis=0),
            W_test=W_last,
            X_pred=np.concatenate(Xs, axis=0),
            Y_pred=np.concatenate(Ys, axis=0),
        )
