"""Host seconds of set-up's first ``train`` calls on the window's chunk:
its eager warm-up iteration, the capture of its graph and two replays (the
checked steps), ending in a synchronize."""


def read(run):
    return run.host.get("capture_s")
