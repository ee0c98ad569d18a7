"""Runtime pieces the port shares with training-style fleets: restart
bookkeeping and the straggler monitor (``fault_tolerance``)."""
