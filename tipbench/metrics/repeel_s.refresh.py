"""repeel_s.refresh: host seconds per cycle in the engine's prefix
re-peel (the program's span ``refresh.repeel``: the matrix and the
carried state uploaded, the level sweeps, the final read), mean over the
traced run's window (``tipbench.program_spans``)."""
from tipbench import program_spans


def read(run):
    return program_spans.mean(run, program_spans.seconds("refresh.repeel"))
