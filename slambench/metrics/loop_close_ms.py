"""`loop_close_ms`: median (ms) over the window's probes outside the
profiled slice that closed a loop (`loop.probe` with its count `closed`
set) of their `loop.verify`, `loop.correct` and `loop.gba` spans summed
(`LoopCloser._after_probe`: the verification with its pack read, the
correction and the inline global BA): on the device's timeline, where the
card records one. Nothing when no loop closed there."""
from slambench.harness import spans

LEG = ("loop.verify", "loop.correct", "loop.gba")


def read(run):
    recs = spans.untraced(run)
    closed = {r["id"] for r in recs if r["name"] == "loop.probe" and r["counts"].get("closed")}
    tot = {i: 0.0 for i in closed}
    for r in recs:
        if r["parent"] in closed and r["name"] in LEG:
            tot[r["parent"]] += spans.seconds(r)
    return spans.median_ms(list(tot.values()))
