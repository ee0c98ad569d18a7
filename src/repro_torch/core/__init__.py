"""Graph substrate, oracles, scheduling and the peel engine."""
