"""glue_roofline: the glue's bytes for the frames in the traced slice (the
packed frames in once, pass 1's float32 plane and the packed chroma out
once) at the memory rate, over the traced device time of the kernels of
the layer "glue" (kernel_groups.json: the glue kernel and the pack of Y),
in %."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    busy = t.layer_us("glue")
    if busy <= 0:
        return None
    return 100.0 * t.frames * run.yard.glue_least_seconds(run.cfg) * 1e6 / busy
