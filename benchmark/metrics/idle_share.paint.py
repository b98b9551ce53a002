"""The device's idle share of the traced window, in %: 1 - (the union of
its kernels, copies and sets) / (the window's host-clock length), the
``busy_s`` and ``window_s`` of the result's ``device``. The profiler
records CUDA activity alone, whose runtime callbacks cost the host little;
recording every host op as well starved the CVAE's paint calls."""


def read(run):
    if run.trace.window_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
