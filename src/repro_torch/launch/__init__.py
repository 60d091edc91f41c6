"""Launchers: the serving driver (one device)."""
