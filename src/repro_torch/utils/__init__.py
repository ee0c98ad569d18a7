"""Cost accounting of the dry run (``op_cost``), and the spans and
counters of the engine's runs (``spans``)."""
