"""pass_roofline: the least time of the passes of the frames in the traced
slice (the larger of their operations over the peak and their bytes over
the memory rate, pass by pass) over the traced device time of the kernels
of the layer "pass" (kernel_groups.json: A1, A2, B), in %."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    busy = t.layer_us("pass")
    if busy <= 0:
        return None
    return 100.0 * t.frames * run.yard.pass_least_seconds(run.cfg) * 1e6 / busy
