"""End-to-end example pipelines of the port (run with ``python -m``)."""
