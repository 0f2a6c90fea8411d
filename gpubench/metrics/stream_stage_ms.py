"""stream_stage_ms: the program's own Tracer span "stage" of
StreamProcessor (a group's pinned staging and its copies enqueued) over the
window (host clock), in ms a group."""


def read(run):
    s = run.window.spans.get("stage")
    if not s or not s["count"]:
        return None
    return 1e3 * s["total_s"] / s["count"]
