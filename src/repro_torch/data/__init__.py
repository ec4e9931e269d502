"""Synthetic data generators (mirrors `repro.data`)."""
