"""Data sources and per-learner streams — the counterpart of
``repro.data``."""
