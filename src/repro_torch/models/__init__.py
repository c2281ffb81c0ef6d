"""The models — the counterpart of ``repro.models`` (so far the paper's
CNN/MLP families and the dense GQA decoder LM)."""
