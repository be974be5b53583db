"""Training of the port: the step factories and checkpointing."""
