"""The paper's models — the counterpart of ``repro.models`` (this slice
ports the CNN/MLP families only)."""
