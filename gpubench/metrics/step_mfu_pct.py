"""step_mfu_pct: the algorithm's operations for the frames the window
completed (the dot and the hash at every pixel of every pass, counted from
the configuration's shapes) over the window's seconds, as a share of the
peak of the precision the configuration states."""


def read(run):
    w = run.window
    if not w.frames or w.seconds <= 0:
        return None
    rate = w.frames * run.yard.frame_ops(run.cfg) / w.seconds
    return 100.0 * rate / run.yard.peak_ops(run.cfg)
