"""Device milliseconds a training step in kernels not launched from the
port's own library (cuDNN's convolutions, batch norms, elementwise work):
the trace's kernels whose names are none of ``harness/port_kernels.json``'s,
over the traced steps."""


def read(run):
    if run.trace.calls == 0 or not run.trace.ops:
        return None
    return (1e3 * run.trace.kernels_outside_s(run.all_port_kernels())
            / run.trace.calls)
