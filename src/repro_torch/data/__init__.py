"""Synthetic inputs of the examples and the service CLI."""
