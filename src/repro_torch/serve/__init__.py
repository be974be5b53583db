"""Serving: the LM's slot engine (``engine``)."""
