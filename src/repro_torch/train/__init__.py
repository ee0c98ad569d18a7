"""Runtime pieces the port shares with training-style fleets: the
straggler monitor (``fault_tolerance``)."""
