"""What several per-layer readers share. A reader takes the run's record
(``cfg``, ``mix``, ``counts`` of the traced window, ``host`` timings of
set-up, ``trace``: a ``core.trace.Trace``) and returns a number, or None
where it finds nothing to read."""

from __future__ import annotations

from benchmark.roofline import bound_s

# the port's hand-written CUDA kernels, by a part of their names
HAND_KERNELS = ("mlp_u_z_", "rollout_kernel", "gbm_terminal")


class ShortTrace(RuntimeError):
    """The trace holds fewer records of a kernel than the window launched."""


def idle_share(run) -> float:
    """% of the traced window in which no operation ran on the card."""
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline(run, patterns, launches: int, work) -> float | None:
    """% of the bound (FLOPs, bytes) = ``work`` that one launch of the kernel
    made of ``patterns`` reaches: the bound over its device time a launch.
    None where the kernel did not run; raises :class:`ShortTrace` unless
    each of its kernels shows ``launches`` records, since a share read from
    fewer records than ran would be wrong."""
    found = [run.trace.kernel(p) for p in patterns]
    if all(n == 0 for n, _ in found):
        return None
    for p, (n, _) in zip(patterns, found):
        if n != launches:
            raise ShortTrace(f"the trace holds {n} records of {p}, expected {launches}")
    seconds = sum(s for _, s in found) / launches
    return 100.0 * bound_s(*work) / seconds
