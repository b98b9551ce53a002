"""Host milliseconds to enqueue one ``paint_batch`` call (the painter,
``painter.py`` and ``transforms.py``): the host clock inside the calls of
the untraced part of the window over its calls."""


def read(run):
    if run.window.calls == 0:
        return None
    return 1e3 * run.window.host_s / run.window.calls
