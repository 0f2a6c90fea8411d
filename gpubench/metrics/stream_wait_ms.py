"""stream_wait_ms: the program's own Tracer span "wait" of StreamProcessor
(the host blocked on a group's event, and the group's numpy views) over the
window (host clock), in ms a group."""


def read(run):
    s = run.window.spans.get("wait")
    if not s or not s["count"]:
        return None
    return 1e3 * s["total_s"] / s["count"]
