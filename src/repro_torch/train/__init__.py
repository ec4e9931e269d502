"""Training-side infrastructure of the port (mirrors `repro.train`):
`optimizer` (AdamW, optionally with int8 moments), `compression` (int8
gradient compression with error feedback) and `checkpoint` (atomic,
optionally asynchronous tree checkpoints, also the streamed analysis's)."""
