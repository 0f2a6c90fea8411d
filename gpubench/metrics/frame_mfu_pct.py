"""frame_mfu_pct: step_mfu_pct's count over the per-frame path's window:
the algorithm's operations for the frames completed over the window's
seconds, as a share of the configuration's peak."""


def read(run):
    w = run.window
    if not w.frames or w.seconds <= 0:
        return None
    rate = w.frames * run.yard.frame_ops(run.cfg) / w.seconds
    return 100.0 * rate / run.yard.peak_ops(run.cfg)
