"""Codec registry."""
