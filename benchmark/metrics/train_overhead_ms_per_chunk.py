"""Host ms a chunk of ``Trainer.train`` spends outside the device's work:
each ``dnnpde.train`` span less its ``replay``, ``capture``, ``warm_up``,
``eager`` and ``wait`` descendants (chunk set-up, read-out, the drain's
host work), over the ``dnnpde.train.chunk`` spans inside them."""

from benchmark.metrics._spans import seconds, store

TRAIN = "dnnpde.train"
DEVICE_BOUND = tuple(f"dnnpde.train.{n}" for n in ("replay", "capture", "warm_up", "eager",
                                                    "wait"))


def _train_of(spans, i: int) -> int:
    """The index of the ``dnnpde.train`` span that holds span ``i``, or -1."""
    p = spans[i].parent
    while p >= 0 and spans[p].name != TRAIN:
        p = spans[p].parent
    return p


def read(run):
    got = store()
    if got is None:
        return None
    spans = got[0]
    trains = {i for i, s in enumerate(spans) if s.name == TRAIN and s.end_ns is not None}
    chunks = sum(1 for i, s in enumerate(spans)
                 if s.name == "dnnpde.train.chunk" and _train_of(spans, i) in trains)
    if not chunks:
        return None
    host = sum(seconds(spans[i]) for i in trains)
    host -= sum(seconds(s) for i, s in enumerate(spans)
                if s.name in DEVICE_BOUND and s.end_ns is not None
                and _train_of(spans, i) in trains)
    return 1e3 * host / chunks
