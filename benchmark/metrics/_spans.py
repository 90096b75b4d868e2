"""What the readers of the program's own spans share. While a profiler
records, ``dnnpde_tpu_torch.tracing`` keeps the port's spans in memory
(name, start and end on ``time.time_ns()``, the enclosing span, ids) and
counts always; the traced window is the only profiled work of a run, so the
spans are the window's, and those of a window traced again. A program
without the module (an older commit), or without the spans asked for,
gives None."""


def store():
    """(spans, counters) of the program, or None where it has no tracing."""
    try:
        import dnnpde_tpu_torch.tracing as tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.counters()


def closed(spans, name: str) -> list:
    return [s for s in spans if s.name == name and s.end_ns is not None]


def seconds(span) -> float:
    return 1e-9 * (span.end_ns - span.start_ns)


def mean_ms(name: str):
    """Mean ms of the closed spans named ``name``, or None."""
    got = store()
    kept = [] if got is None else closed(got[0], name)
    return 1e3 * sum(map(seconds, kept)) / len(kept) if kept else None
