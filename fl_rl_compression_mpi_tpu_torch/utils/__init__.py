"""Timers."""
