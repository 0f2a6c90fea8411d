"""step_enqueue_ms: the mean host duration of the program's own span
"raisr.step" (RaisrEngine.process_batch_device) over the traced slice, in
ms: how long the host takes to enqueue a step, under the profiler."""


def read(run):
    t = run.trace
    if t is None:
        return None
    durs = [e.dur for e in t.host if e.name == "raisr.step" and e.cat == "user_annotation"]
    if not durs:
        return None
    return sum(durs) / len(durs) / 1e3
