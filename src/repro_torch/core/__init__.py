"""Assembly algorithms on torch tensors (mirrors `repro.core`)."""
