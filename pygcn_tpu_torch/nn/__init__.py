"""Layers and parameter initializers."""
