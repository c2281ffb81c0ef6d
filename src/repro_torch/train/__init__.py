"""The protocol training loop — the counterpart of ``repro.train``."""
