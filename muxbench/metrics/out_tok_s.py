"""Output tokens committed in the window, every model and every request
(finished or not), over the window's seconds."""


def read(run):
    w = run.window
    return w.tokens / (w.t1 - w.t0)
