"""Model families of the port (the reference's ``repro.models``): the
shared building blocks (``layers``), the two-tower retrieval model
(``recsys``), and the language models (``attention``, ``moe``,
``transformer``)."""
