"""Launchers of the port: `train` (mirrors `repro.launch.train`) and
`mesh`, the data mesh over a process group (mirrors `repro.launch.mesh`'s
`make_data_mesh`).  The reference's dry-run, sharding and roofline
modules and its production mesh plan a TPU pod's layout and have no
counterpart on eager cards."""
