"""Cost accounting of the dry run."""
