"""plan_ms.decompose: host ms of ``Executor.plan`` per request (the
benchmark's ``tipbench.plan`` span), mean over the traced run's window."""


def read(run):
    recs = [r["plan_s"] for r in run.get("records", []) if "plan_s" in r]
    return 1e3 * sum(recs) / len(recs) if recs else None
