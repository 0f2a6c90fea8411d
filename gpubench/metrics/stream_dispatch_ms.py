"""stream_dispatch_ms: the program's own Tracer span "dispatch" of
StreamProcessor.process over the window (host clock), in ms a group."""


def read(run):
    s = run.window.spans.get("dispatch")
    if not s or not s["count"]:
        return None
    return 1e3 * s["total_s"] / s["count"]
