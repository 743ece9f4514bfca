"""`fast_nms_roofline_pct`: kernel 1 (`csrc/fast_nms.cu`) as a share (%) of
its roofline: the least time its bytes take at the HBM peak
(`harness.roofline.fast_nms_bytes` of the configuration's image size and
levels, both eyes) over its mean device time per launch in the profiled
slice. Nothing when the slice holds no launch of it."""
from slambench.harness import roofline


def read(run):
    if run.trace is None:
        return None
    w0, w1 = run.trace.window
    t = [b - a for name, a, b in run.trace.device
         if roofline.FAST_NMS_KERNEL in name and a >= w0 and b <= w1]
    if not t:
        return None
    cam, orb = run.config["slam"]["camera"], run.config["slam"]["orb"]
    n_bytes = roofline.fast_nms_bytes(int(cam["height"]), int(cam["width"]),
                                      int(orb["n_levels"]), batch=2)
    return 100.0 * roofline.bound_seconds(n_bytes) / (sum(t) / len(t))
