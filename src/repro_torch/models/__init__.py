"""Model families of the port (the reference's ``repro.models``): the
shared building blocks (``layers``) and the two-tower retrieval model
(``recsys``)."""
