"""stream_copy_ms: device ms a group of the host-to-device and
device-to-host copies in the traced slice (the layer "copy" of
kernel_groups.json), a group being `batch` frames of the traffic."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    copy_us = t.layer_us("copy")
    if copy_us <= 0:
        return None
    return copy_us / 1e3 / (t.frames / run.traffic["batch"])
