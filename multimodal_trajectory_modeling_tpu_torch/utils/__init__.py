"""Training observability (``trace``)."""
