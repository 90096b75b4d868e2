"""Training schedules of the port: time-step refinement and the two-phase
learning-rate protocol, the counterpart of ``dnnpde_tpu/train/schedules.py``
(pure Python, so the iteration -> N map is the JAX package's exactly).

- Time-step refinement (coarse -> fine N): ``N = ceil(Mm^(it // 4000 + 1))``
  for 4000 <= it < 20000 and ``ceil(Mm)`` before; past 20000 the last ramp
  value persists (the reference stops updating N there). Each distinct N is
  its own captured training iteration in the Trainer, so the schedule is
  handed out as *buckets* of contiguous iterations that share one N.
- Two-phase protocol: an initial phase at lr 1e-3, then fine-tuning at
  lr 1e-5, as data that drives ``Trainer.train`` calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional


@dataclasses.dataclass(frozen=True)
class TimeStepRefinement:
    """The reference's coarse-to-fine N schedule.

    Mm: refinement base (the reference passes ``Mm ≈ N**(1/5)``).
    ramp_start, ramp_period, ramp_end: iteration breakpoints (4000 / 4000 /
      20000 in the reference).
    n_cap: optional upper bound on N.
    """

    Mm: float
    ramp_start: int = 4000
    ramp_period: int = 4000
    ramp_end: int = 20000
    n_cap: Optional[int] = None

    def n_at(self, it: int) -> int:
        if it < self.ramp_start:
            n = math.ceil(self.Mm)
        elif it < self.ramp_end:
            n = math.ceil(self.Mm ** (it // self.ramp_period + 1))
        else:
            # the last ramp value persists: a long run does not fall back to
            # the coarsest grid
            n = math.ceil(self.Mm ** ((self.ramp_end - 1) // self.ramp_period + 1))
        if self.n_cap is not None:
            n = min(n, self.n_cap)
        return max(n, 1)

    def buckets(self, start_it: int, n_iter: int) -> Iterator[tuple[int, int, int]]:
        """Yield (start, length, N) runs of contiguous iterations with equal N."""
        it = start_it
        end = start_it + n_iter
        while it < end:
            n = self.n_at(it)
            j = it
            while j < end and self.n_at(j) == n:
                j += 1
            yield it, j - it, n
            it = j


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One phase of the two-phase protocol."""

    n_iter: int
    learning_rate: float
    optimizer_type: str = "Adam"


def two_phase(
    initial_iters: int = 2000,
    initial_lr: float = 1e-3,
    fine_iters: int = 500,
    fine_lr: float = 1e-5,
    optimizer_type: str = "Adam",
) -> tuple[PhaseSpec, PhaseSpec]:
    """The reference's canonical two-phase schedule: 2000 iterations at 1e-3,
    then 500 at 1e-5."""
    return (
        PhaseSpec(initial_iters, initial_lr, optimizer_type),
        PhaseSpec(fine_iters, fine_lr, optimizer_type),
    )
