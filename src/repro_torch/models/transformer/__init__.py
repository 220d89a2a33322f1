"""The decoder-only LM family: attention kinds and the model."""
