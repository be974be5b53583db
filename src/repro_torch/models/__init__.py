"""The LM side: decoder stacks of every family (dense, MoE, Mamba2 and
hybrid; ``model``), their layers, attention, Mamba2 and MoE blocks and the
stack over blocks."""
