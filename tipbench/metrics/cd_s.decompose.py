"""cd_s.decompose: seconds of counting and CD per request, the program's
``RunStats.time_count + time_cd``, mean over the traced run's window."""


def read(run):
    recs = [r["time_count"] + r["time_cd"] for r in run.get("records", [])
            if "plan_s" in r]
    return sum(recs) / len(recs) if recs else None
