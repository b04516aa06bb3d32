"""Training observability (``trace``), the numpy state-space helpers
(``state_space``) and the ADNI adapter (``adni``)."""
