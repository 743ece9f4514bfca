"""`loop_close_host_ms`: median (ms) over the window's probes outside the
profiled slice that closed a loop (`loop.probe` with its count `closed`
set) of their `loop.verify`, `loop.correct` and `loop.gba` spans summed
(`loop_close_ms`'s spans: the loop leg, which the mapper thread runs
holding the map lock) on the host clock, for a deployment whose threads
share the one stream. Nothing when no loop closed there."""
from slambench.harness import spans

LEG = ("loop.verify", "loop.correct", "loop.gba")


def read(run):
    recs = spans.untraced(run)
    closed = {r["id"] for r in recs if r["name"] == "loop.probe" and r["counts"].get("closed")}
    tot = {i: 0.0 for i in closed}
    for r in recs:
        if r["parent"] in closed and r["name"] in LEG:
            tot[r["parent"]] += r["host_s"]
    return spans.median_ms(list(tot.values()))
