"""frame_host_ms: per frame of the traced slice, the wall time of its call
minus the union of the device operations inside it: the host's time in
the C ABI's path (views, widening, pageable copies, packing), in ms."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    frames = [r for r in t.ranges if r.name == "gpubench.frame"]
    if not frames:
        return None
    host = [r.dur - t.busy_us(r.ts, r.end) for r in frames]
    return sum(host) / len(host) / 1e3
