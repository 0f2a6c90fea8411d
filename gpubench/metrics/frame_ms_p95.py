"""frame_ms_p95: the 95th percentile, over every frame completed in the
window, of the time from when the caller hands the frame in to when its
upscaled planes are in host memory, in ms (numpy's linear percentile)."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
