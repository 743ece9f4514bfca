"""`keyframes_per_100`: keyframes made per 100 window frames (the tracker's
keyframe policy)."""


def read(run):
    if not run.frames:
        return None
    return 100.0 * sum(1 for f in run.frames if f.kf) / len(run.frames)
