"""frames_per_s: output frames completed in the window over the window's
seconds, on the host clock; the window ends in a synchronize (or with the
last frame in host memory)."""


def read(run):
    w = run.window
    return w.frames / w.seconds if w.frames and w.seconds > 0 else None
