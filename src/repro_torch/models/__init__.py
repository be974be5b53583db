"""The LM side: dense decoder stacks for serving (``model``), their
layers, attention and the stack over blocks."""
