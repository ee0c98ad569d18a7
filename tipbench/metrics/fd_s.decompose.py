"""fd_s.decompose: seconds of FD per request, the program's
``RunStats.time_fd``, mean over the traced run's window."""


def read(run):
    recs = [r["time_fd"] for r in run.get("records", []) if "plan_s" in r]
    return sum(recs) / len(recs) if recs else None
