"""wide_mb.decompose: MB per request of the float64 buffers the program
allocates on the card for supports and their peel deltas, tip numbers,
bounds and B2 stacks (``stats.trace.wide_bytes``, counted where each is
made), mean over the traced run's window (``tipbench.program_spans``).
None where the program keeps no such counter."""
from tipbench import program_spans


def read(run):
    runs = program_spans.window_runs(run)
    if not runs or not hasattr(runs[0].trace, "wide_bytes"):
        return None
    return program_spans.mean(run, lambda trace: trace.wide_bytes / 1e6)
