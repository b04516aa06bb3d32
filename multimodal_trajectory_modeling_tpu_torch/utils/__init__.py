"""Training observability (``trace``), step checkpoints (``checkpoint``),
the numpy state-space helpers (``state_space``) and the ADNI adapter
(``adni``)."""
