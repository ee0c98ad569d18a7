"""delta_share.refresh: % of cycles whose flush report counts a delta
refresh (the service's incremental route) over the cycles run."""


def read(run):
    recs = [r for r in run.get("records", []) if "flush_s" in r]
    if not recs:
        return None
    return 100.0 * sum(1 for r in recs if r["delta"] and not r["full"]) \
        / len(recs)
