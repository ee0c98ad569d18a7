"""round_trips.refresh: the refresh's blocking device-to-host reads per
cycle (the served result's ``RunStats.host_round_trips``), mean over the
traced run's window."""


def read(run):
    recs = [r["round_trips"] for r in run.get("records", [])
            if "flush_s" in r]
    return sum(recs) / len(recs) if recs else None
