"""Host milliseconds inside one ``step_indices`` call (the trainer,
``train/trainer.py`` and ``data/device_cache.py``): the host clock inside
the steps of the untraced part of the window over its steps. A step that
waits for the device inside the call counts that wait."""


def read(run):
    if run.window.calls == 0:
        return None
    return 1e3 * run.window.host_s / run.window.calls
