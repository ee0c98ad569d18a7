"""The hand kernels' share of their roofline (%) over one more request
after the window: the sum of each wrapped call's least time
(``tipbench.bounds``) over the device time of the operations inside the
calls, from the profiler's device events (``trace.RooflineProbe``).
None when no call was seen."""


def read(run):
    share = run.get("roofline")
    return None if share is None else 100.0 * share
