"""device_idle_pct.batch: 100 minus the share of the traced window in which
a device operation (kernel, copy or memset) ran, on the batched paths."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_us <= 0:
        return None
    return 100.0 - 100.0 * t.busy_us() / t.window_us
