"""Mean time from a request's submission to the start of the tick that
admitted it, over the requests submitted in the window and admitted
before the profiler started, from the harness's own timestamps."""


def read(rec):
    end = rec["host_end"]
    waits = [r["admit"] - r["submit"] for r in rec["requests"]
             if r["in_window"] and r["admit"] is not None
             and r["admit"] < end]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
