"""gather_roofline: the least time of the gather A2 (gather_resident_kernel)
for the frames in the traced slice, over the traced device time of the
group "pass A2 gather_resident_kernel" (kernel_groups.json), in %.

A2's least time, pass by pass, is the larger of its operations (the 121-tap
dot, DOT_OPS a pixel) over the peak of the precision the configuration
states and its bytes (BYTES_PER_PIXEL) over the memory rate: the rule of
`pass_least_seconds`, for the dot alone, so it counts the same work
whatever kernel does it."""

GROUP = "pass A2 gather_resident_kernel"
# a pixel's bytes: the float32 cheap plane in, the uint8 bucket that A1
# wrote in, the float32 raw plane out
BYTES_PER_PIXEL = 4 + 1 + 4


def gather_least_seconds(cfg, yard):
    """The least time of A2 over the passes of one frame."""
    return sum(yard.least_seconds(h * w * yard.DOT_OPS, h * w * BYTES_PER_PIXEL,
                                  cfg["dtype"])[0]
               for h, w in yard.pass_planes(cfg))


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    busy = t.group_us().get(GROUP, 0.0)
    if busy <= 0:
        return None
    return 100.0 * t.frames * gather_least_seconds(run.cfg, run.yard) * 1e6 / busy
