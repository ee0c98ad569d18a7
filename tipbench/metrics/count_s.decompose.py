"""count_s.decompose: host seconds per request in the program's counting
pass (the span ``count``: the count's launch and, on the subset dispatch,
its fetch and the exact-limit check), mean over the traced run's window
(``tipbench.program_spans``).  None where no run of the window has the
span, as a program without it."""
from tipbench import program_spans


def read(run):
    runs = program_spans.window_runs(run)
    if not runs or not any("count" in s.trace.calls for s in runs):
        return None
    return program_spans.mean(run, program_spans.seconds("count"))
