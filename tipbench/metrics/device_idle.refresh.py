"""The device's idle share (%) of a cycle at the program's own pace:
1 - (busy time a traced cycle, from a profile of the device's activity
alone) / (wall time an untraced cycle of the same window)
(``trace.idle_share``).  None without a traced device."""
from tipbench import trace


def read(run):
    return trace.idle_share(run)
