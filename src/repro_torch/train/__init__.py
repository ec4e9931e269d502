"""Training-side infrastructure of the port: so far only the checkpointer
the streamed analysis needs (`checkpoint.Checkpointer`)."""
