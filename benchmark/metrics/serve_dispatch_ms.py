"""Mean host ms from the call of ``u_and_grad_device`` to its return, with
no synchronize inside, over one cycle of request sizes sent before the
traced window."""


def read(run):
    d = run.host.get("dispatch_s")
    return None if not d else 1e3 * sum(d) / len(d)
