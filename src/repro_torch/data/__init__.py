"""Data of the port: the paper's tensors as synthetic replicas."""
