"""Composed models: the encoder and its streaming front end."""
