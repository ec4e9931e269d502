"""Launchers of the port: `train` (mirrors `repro.launch.train`).  The
reference's dry-run, mesh, sharding and roofline modules plan a TPU pod's
layout and have no counterpart on one eager card."""
