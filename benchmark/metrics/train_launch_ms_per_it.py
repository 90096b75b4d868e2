"""Host ms a replayed iteration takes to launch: the program's
``dnnpde.train.replay`` spans (the loop of ``graph.replay()`` calls, one a
chunk) over the replays they hold. Near the device's time an iteration when
a full launch queue holds the host back; far under it when the host runs
ahead and waits in ``dnnpde.train.wait``."""

from benchmark.metrics._spans import closed, seconds, store


def read(run):
    got = store()
    replays = [] if got is None else closed(got[0], "dnnpde.train.replay")
    n = sum(s.ids["replays"] for s in replays)
    return 1e3 * sum(map(seconds, replays)) / n if n else None
