"""round_trips.decompose: the program's blocking device-to-host reads per
request (``RunStats.host_round_trips``), mean over the traced run's
window."""


def read(run):
    recs = [r["round_trips"] for r in run.get("records", [])
            if "plan_s" in r]
    return sum(recs) / len(recs) if recs else None
