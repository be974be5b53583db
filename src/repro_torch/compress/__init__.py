"""Checkpoint compression of the port (the codec registry over a params tree)."""
